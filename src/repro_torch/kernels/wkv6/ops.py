"""Dispatch by device for the RWKV6 WKV recurrence: the CUDA kernel for a
CUDA tensor, the plain PyTorch version for a CPU tensor."""
from __future__ import annotations

import torch

from . import kernel, ref

CHUNK_THRESHOLD = 256


def wkv(r, k, v, w, u) -> torch.Tensor:
    """RWKV6 recurrence. r,k,v,w: (B, H, T, D); u: (H, D).

    A CPU tensor goes to :mod:`.ref`, as the reference dispatches off the
    TPU: the chunked parallel form when ``T >= 256`` and ``T % 64 == 0``,
    else the step-by-step scan.  Any other tensor goes to the kernel, for
    any T, which launches or raises.
    """
    if r.device.type == "cpu":
        t = r.shape[2]
        if t >= CHUNK_THRESHOLD and t % 64 == 0:
            return ref.wkv_chunked(r, k, v, w, u, chunk=64)
        return ref.wkv(r, k, v, w, u)
    return kernel.wkv(r, k, v, w, u)


wkv_step = ref.wkv_step  # decode path: single step, plain torch everywhere
