"""Dispatch by device: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  A CPU tensor goes to
    :mod:`.ref`, as the reference dispatches off the TPU: the blocked
    form when ``S >= 4096`` and ``S % 1024 == 0`` (no (S, S) scores),
    else the exact form.  Any other tensor goes to the kernel, for any S,
    which launches or raises.
    """
    if q.device.type == "cpu":
        s = q.shape[2]
        if s >= 4096 and s % 1024 == 0:
            return ref.blocked_attention(q, k, v, causal=causal,
                                         window=window)
        return ref.attention(q, k, v, causal=causal, window=window)
    return kernel.flash_attention(q, k, v, causal=causal, window=window)
