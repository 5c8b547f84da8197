"""The card's constants for the roofline model (``launch/dryrun.py``).

The counterpart of the reference's ``launch/mesh.py``, whose constants
are a TPU v5e's: here they are one NVIDIA H100 80GB HBM3 (SXM, 700 W)'s,
from NVIDIA's H100 Tensor Core GPU data sheet (dense rates, without
sparsity).  ``chip_smoke.py`` takes its bounds from them too.

The mesh constructors (``make_production_mesh``, ``make_host_mesh``,
``make_cohort_mesh``) wait for the multi-device slice (ROADMAP).
"""
from __future__ import annotations

import torch

__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "HBM_BW", "NVLINK_BW",
           "peak_flops"]

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 on the CUDA cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 900e9               # bytes/s, NVLink 4, all links of one card


def peak_flops(dtype) -> float:
    """The peak rate for operands of ``dtype`` (a torch dtype or its
    name): bf16 (and f16) on the tensor cores, anything else at the f32
    rate."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return (PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16)
            else PEAK_FLOPS_F32)
