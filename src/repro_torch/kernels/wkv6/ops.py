"""Dispatch by device for the RWKV6 WKV recurrence: the CUDA kernels for a
CUDA tensor, the plain PyTorch version for a CPU tensor, and for a
``meta`` tensor too, as one region (:mod:`..region`)."""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ...analysis.contracts import check_kernel_outputs
from .. import region
from . import kernel, ref

CHUNK_THRESHOLD = 256


class WKV(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient.

    ``ctx`` keeps the inputs; ``backward`` hands them and the output's
    gradient (made contiguous) to :func:`kernel.wkv_backward`."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        out = kernel.wkv(r, k, v, w, u)
        check_kernel_outputs("wkv6", out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        grads = kernel.wkv_backward(*ctx.saved_tensors, do.contiguous())
        check_kernel_outputs("wkv6_backward", *grads)
        return grads


def wkv(r, k, v, w, u) -> torch.Tensor:
    """RWKV6 recurrence. r,k,v,w: (B, H, T, D); u: (H, D).

    A CPU tensor goes to :mod:`.ref`, as the reference dispatches off the
    TPU: the chunked parallel form when ``T >= 256`` and ``T % 64 == 0``,
    else the step-by-step scan; autograd differentiates it.  A ``meta``
    tensor goes to the same plain version, as one region forward and one
    backward.  Any other tensor goes to the kernels through :class:`WKV`,
    for any T, which launch or raise.  A DTensor raises: under a mesh
    the caller hands over local shards.
    """
    region.local_only("wkv6", r, k, v, w, u)
    if r.device.type in ("cpu", "meta"):
        t = r.shape[2]
        plain = (ref.wkv_chunked if t >= CHUNK_THRESHOLD and t % 64 == 0
                 else ref.wkv)
        if r.device.type == "meta":
            return region.run("wkv6", plain, r, k, v, w, u)
        return plain(r, k, v, w, u)
    return WKV.apply(r, k, v, w, u)


wkv_step = ref.wkv_step  # decode path: single step, plain torch everywhere
