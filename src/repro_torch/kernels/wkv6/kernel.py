"""Wrapper of the Hopper ``wkv6`` kernel (``csrc/wkv6.cu``).

The counterpart of the reference's Pallas kernel
(``repro/kernels/wkv6/kernel.py``): the RWKV6 recurrence per (b, h) from
a zero f32 state, output in r's type (f32 or bf16), for any sequence
length.  The C entry point picks the kernel by type: bfloat16 at head
dims of 16 and up takes the chunk-parallel form on the tensor cores,
float32 (and bfloat16 at D = 8) the column-split scan on the CUDA cores.
The wrapper checks what the kernels take and raises on anything else,
allocates the output, launches on the current stream and never
synchronizes.  ``wkv.launches`` counts launches.

:func:`wkv_backward` wraps the gradient kernels (``csrc/wkv6_bwd.cu``, a
library of its own): dr, dk, dv, dw and du from the forward's inputs and
the output's gradient, in three launches counted once in
``wkv_backward.launches``.  Its C entry point picks the design by type as
the forward's does: bfloat16 at head dims of 16 and up takes the chunked
form on the tensor cores, float32 (and bfloat16 at D = 8) the scan on
the CUDA cores; :func:`backward_variant_launches` counts each.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
SOURCE_BWD = SOURCE.with_name("wkv6_bwd.cu")
# the backward's states are kept every CHUNK steps over T; the scan design
# also every CKPT_SUB_STEPS steps within one such chunk (csrc/wkv6_bwd.cu)
CHUNK, CKPT_SUB_STEPS = 64, 8
HEAD_DIMS = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the backward's designs, as its C entry point numbers them
BACKWARD_VARIANTS = ("cuda_cores", "tensor_cores")


@functools.lru_cache(maxsize=None)
def build():
    """Compile (at first use) and bind the kernel's C entry point."""
    fn = load_library(SOURCE).wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def build_backward():
    """Compile (at first use) and bind the backward's C entry point."""
    fn = load_library(SOURCE_BWD).wkv6_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_variant_counter():
    fn = load_library(SOURCE_BWD).wkv6_backward_variant_launches
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_ulonglong
    return fn


def backward_variant_launches() -> dict:
    """Backward calls that succeeded in this process, by design, as its C
    entry point counts them: ``cuda_cores`` (the scan: float32, and
    bfloat16 at D = 8) and ``tensor_cores`` (the chunked form: bfloat16
    at D >= 16).  Builds the library at first use."""
    fn = _backward_variant_counter()
    return {name: int(fn(i)) for i, name in enumerate(BACKWARD_VARIANTS)}


def _check(r, k, v, w, u) -> None:
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 kernel needs CUDA tensors, got r on "
                         f"{r.device}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16, got "
                        f"{r.dtype}")
    if r.ndim != 4:
        raise ValueError(f"wkv6 kernel takes r, k, v, w (B, H, T, D), got "
                         f"{tuple(r.shape)}")
    b, h, t, d = r.shape
    for name, x, shape in (("r", r, r.shape), ("k", k, r.shape),
                           ("v", v, r.shape), ("w", w, r.shape),
                           ("u", u, (h, d))):
        if x.device != r.device or x.dtype != r.dtype or x.shape != shape:
            raise ValueError(f"{name} must be {r.dtype} {tuple(shape)} on "
                             f"{r.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"wkv6 kernel needs {name} contiguous and "
                             f"16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head dims {HEAD_DIMS}, got {d}")
    if b < 1 or h < 1 or t < 1 or b * h >= 2 ** 31:
        raise ValueError(f"wkv6 kernel takes 1 <= B*H < 2**31 and T >= 1, "
                         f"got {tuple(r.shape)}")


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: (B, H, T, D); u: (H, D), all one type on a CUDA device.

    Returns (B, H, T, D) in r's type."""
    _check(r, k, v, w, u)
    b, h, t, d = r.shape
    out = torch.empty_like(r)
    launch = build()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), out.data_ptr(), b, h, t, d,
                    _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {rc} "
                           f"(r {tuple(r.shape)}, {r.dtype})")
    wkv.launches += 1
    return out


wkv.launches = 0


def wkv_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, do: torch.Tensor):
    """Gradients of :func:`wkv` on a CUDA device.

    r, k, v, w, do: (B, H, T, D); u: (H, D), all one type and contiguous;
    ``do`` is the gradient of the loss with respect to ``wkv``'s output.
    Returns (dr, dk, dv, dw, du) in r's type; ``dw`` is the gradient with
    respect to the decay ``w`` itself, ``du`` is summed over B and T."""
    _check(r, k, v, w, u)
    if do.device != r.device or do.dtype != r.dtype or do.shape != r.shape:
        raise ValueError(f"do must be {r.dtype} {tuple(r.shape)} on "
                         f"{r.device}, got {do.dtype} {tuple(do.shape)} on "
                         f"{do.device}")
    if not do.is_contiguous() or do.data_ptr() % 16:
        raise ValueError("wkv6 backward needs do contiguous and 16-byte "
                         "aligned")
    b, h, t, d = r.shape
    grads = [torch.empty_like(x) for x in (r, k, v, w, u)]
    f32 = dict(dtype=torch.float32, device=r.device)
    # scratch that either design fits in: the chunked form keeps a du
    # partial per chunk, the states at every chunk's start and their
    # gradients at every chunk's end; the scan a du partial per (b, h), the
    # states at every chunk's start and within one chunk
    n = -(-t // CHUNK)
    scratch = [torch.empty(shape, **f32) for shape in (
        (b, h, n, d), (b, h, n, d, d),
        (b, h, max(n, CHUNK // CKPT_SUB_STEPS), d, d))]
    launch = build_backward()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(*(x.data_ptr() for x in (r, k, v, w, u, do, *grads,
                                             *scratch)),
                    b, h, t, d, _DTYPES[r.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 backward launch failed: CUDA error {rc} "
                           f"(r {tuple(r.shape)}, {r.dtype})")
    wkv_backward.launches += 1
    return tuple(grads)


wkv_backward.launches = 0
