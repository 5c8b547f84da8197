"""Wrapper of the Hopper ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The counterpart of the reference's Pallas kernel
(``repro/kernels/flash_attention/kernel.py``): causal / sliding-window
GQA attention with an f32 online softmax, output in q's type (f32 or
bf16), for any sequence length.  The C entry point picks the kernel by
type alone: bfloat16 runs on the tensor cores
(``csrc/flash_attention_wgmma.cuh``), float32 on the CUDA cores.  The
wrapper checks what the kernels take and raises on anything else,
allocates the output, launches on the current stream and never
synchronizes.  ``flash_attention.launches`` counts launches;
:func:`variant_launches` reads the C entry point's count by kernel.  With
``return_lse`` the forward also returns each row's log-sum-exp (base 2,
f32) for the backward.

:func:`flash_attention_backward` wraps the gradient kernels
(``csrc/flash_attention_bwd.cu``, a library of its own, which sends
bfloat16 to ``csrc/flash_attention_bwd_wgmma.cuh`` on the tensor cores
and float32 to the CUDA cores): dq, dk and dv from q, k, v, the forward's
output and log-sum-exp and the output's gradient, in three launches
counted once in ``flash_attention_backward.launches``;
:func:`backward_variant_launches` reads its count by design.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ..build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
SOURCE_BWD = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry point's kernels, by its variant number
VARIANTS = ("cuda_cores", "tensor_cores")


@functools.lru_cache(maxsize=None)
def build():
    """Compile (at first use) and bind the kernel's C entry point."""
    fn = load_library(SOURCE).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def build_lse():
    """Bind the entry point that also writes the rows' log-sum-exp."""
    fn = load_library(SOURCE).flash_attention_lse_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def build_backward():
    """Compile (at first use) and bind the backward's C entry point."""
    fn = load_library(SOURCE_BWD).flash_attention_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _variant_counter():
    fn = load_library(SOURCE).flash_attention_variant_launches
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_ulonglong
    return fn


def variant_launches() -> dict:
    """Launches that succeeded in this process, by kernel, as the C entry
    point counts them: ``cuda_cores`` (float32) and ``tensor_cores``
    (bfloat16).  Builds the library at first use."""
    fn = _variant_counter()
    return {name: int(fn(i)) for i, name in enumerate(VARIANTS)}


@functools.lru_cache(maxsize=None)
def _backward_variant_counter():
    fn = load_library(SOURCE_BWD).flash_attention_backward_variant_launches
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_ulonglong
    return fn


def backward_variant_launches() -> dict:
    """Backward calls that succeeded in this process, by design, as its C
    entry point counts them: ``cuda_cores`` (float32) and
    ``tensor_cores`` (bfloat16)."""
    fn = _backward_variant_counter()
    return {name: int(fn(i)) for i, name in enumerate(VARIANTS)}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention kernel takes q (B, Hq, S, D) and "
                         f"k, v (B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0] != b or k.shape[2:] != (s, d) or hkv < 1
            or hq % hkv or s < 1):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (Hq must be a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if not 1 <= b <= 65535 or not 1 <= hq <= 65535:
        raise ValueError(f"batch and heads must lie in 1..65535, got "
                         f"{b}, {hq}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel needs {name} "
                             f"contiguous and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) on a CUDA device.

    Returns (B, Hq, S, D) in q's type; ``window`` keeps the keys
    ``c > r - window`` of row ``r`` (None: no window).  With
    ``return_lse``, returns (out, lse): lse (B, Hq, S) f32, each row's
    log-sum-exp of its scaled scores in base 2 (``ref.row_lse``), as the
    backward takes it."""
    _check(q, k, v, window)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if return_lse:
        lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
        launch = build_lse()
        args.append(lse.data_ptr())
    else:
        launch = build()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*args, b, hq, k.shape[1], s, d, int(causal),
                    -1 if window is None else int(window), _DTYPES[q.dtype],
                    stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True,
                             window: Optional[int] = None):
    """Gradients of :func:`flash_attention` on a CUDA device.

    q, o, do: (B, Hq, S, D); k, v: (B, Hkv, S, D), all one type and
    contiguous; ``o`` and ``lse`` are what the forward returned with
    ``return_lse`` for the same arguments and ``do`` the gradient of the
    loss with respect to ``o``.  Returns (dq, dk, dv) in q's type, dk and
    dv summed over each KV head's query heads.  bfloat16 runs on the
    tensor cores, float32 on the CUDA cores; a call either launches or
    raises."""
    _check(q, k, v, window)
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention backward needs {name} "
                             f"contiguous and 16-byte aligned")
    b, hq, s, d = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, hq, s) or not lse.is_contiguous()
            or lse.data_ptr() % 16):
        raise ValueError(f"lse must be contiguous float32 {(b, hq, s)} on "
                         f"{q.device}, 16-byte aligned, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    launch = build_backward()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), b, hq,
                    k.shape[1], s, d, int(causal),
                    -1 if window is None else int(window), _DTYPES[q.dtype],
                    stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {rc} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
