"""Dispatch by device for the RWKV6 WKV recurrence: the CUDA kernels for a
CUDA tensor, the plain PyTorch version for a CPU tensor."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import kernel, ref

CHUNK_THRESHOLD = 256


class WKV(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient.

    ``ctx`` keeps the inputs; ``backward`` hands them and the output's
    gradient (made contiguous) to :func:`kernel.wkv_backward`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return kernel.wkv(r, k, v, w, u)

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        return kernel.wkv_backward(*ctx.saved_tensors, do.contiguous())


def wkv(r, k, v, w, u) -> torch.Tensor:
    """RWKV6 recurrence. r,k,v,w: (B, H, T, D); u: (H, D).

    A CPU tensor goes to :mod:`.ref`, as the reference dispatches off the
    TPU: the chunked parallel form when ``T >= 256`` and ``T % 64 == 0``,
    else the step-by-step scan; autograd differentiates it.  Any other
    tensor goes to the kernels through :class:`WKV`, for any T, which
    launch or raise.
    """
    if r.device.type == "cpu":
        t = r.shape[2]
        if t >= CHUNK_THRESHOLD and t % 64 == 0:
            return ref.wkv_chunked(r, k, v, w, u, chunk=64)
        return ref.wkv(r, k, v, w, u)
    return WKV.apply(r, k, v, w, u)


wkv_step = ref.wkv_step  # decode path: single step, plain torch everywhere
