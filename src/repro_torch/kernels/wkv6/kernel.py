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
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
HEAD_DIMS = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def build():
    """Compile (at first use) and bind the kernel's C entry point."""
    fn = load_library(SOURCE).wkv6_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
