"""Wrapper of the Hopper ``fedavg_agg`` kernel (``csrc/fedavg_agg.cu``).

The counterpart of the reference's Pallas kernel
(``repro/kernels/fedavg_agg/kernel.py``): ``out[p] = sum_c w[c] x[c, p]``
over the leading client axis, f32 accumulation, output in the input's
type (f32 or bf16).  The wrapper checks what the kernel takes and raises
on anything else, allocates the output, launches on the current stream
and never synchronizes.  ``weighted_aggregate.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "fedavg_agg.cu"
MAX_CLIENTS = 12288  # the weights live in 48 KB of shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def build():
    """Compile (at first use) and bind the kernel's C entry point."""
    fn = load_library(SOURCE).fedavg_agg_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """stacked (C, ...) on a CUDA device -> (...,) weighted sum over C."""
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_agg kernel needs a CUDA tensor, got one "
                         f"on {stacked.device}")
    if stacked.dtype not in _DTYPES:
        raise TypeError(f"fedavg_agg kernel takes float32 or bfloat16, "
                        f"got {stacked.dtype}")
    if stacked.ndim < 1 or not stacked.is_contiguous():
        raise ValueError("fedavg_agg kernel needs a contiguous (C, ...) "
                         "tensor")
    c = stacked.shape[0]
    p = stacked.numel() // c if c else 0
    if not 1 <= c <= MAX_CLIENTS or p < 1:
        raise ValueError(f"fedavg_agg kernel takes 1..{MAX_CLIENTS} clients "
                         f"of at least one element, got shape "
                         f"{tuple(stacked.shape)}")
    if (weights.dtype != torch.float32 or weights.shape != (c,)
            or weights.device != stacked.device
            or not weights.is_contiguous()):
        raise ValueError(f"weights must be a contiguous float32 ({c},) "
                         f"tensor on {stacked.device}, got "
                         f"{weights.dtype} {tuple(weights.shape)} on "
                         f"{weights.device}")
    out = torch.empty(stacked.shape[1:], dtype=stacked.dtype,
                      device=stacked.device)
    launch = build()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(stacked.data_ptr(), weights.data_ptr(), out.data_ptr(),
                    c, p, _DTYPES[stacked.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_agg launch failed: CUDA error {rc} "
                           f"(shape {tuple(stacked.shape)}, "
                           f"{stacked.dtype})")
    weighted_aggregate.launches += 1
    return out


weighted_aggregate.launches = 0
