"""Dispatch by device: the CUDA kernels for a CUDA tensor, the plain
PyTorch version for a CPU tensor, and for a ``meta`` tensor too, as one
region (:mod:`..region`)."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ...analysis.contracts import check_kernel_outputs
from .. import region
from . import kernel, ref


class FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient.

    ``ctx`` keeps q, k, v, the output and the rows' log-sum-exp that the
    forward writes beside it (under remat, the recompute's); ``backward``
    hands them and the output's gradient (made contiguous: it arrives as a
    transpose from ``gqa_apply``) to
    :func:`kernel.flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = kernel.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
        check_kernel_outputs("flash_attention", o)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_backward(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            window=ctx.window)
        check_kernel_outputs("flash_attention_backward", dq, dk, dv)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  A CPU tensor goes to
    :mod:`.ref`, as the reference dispatches off the TPU: the blocked
    form when ``S >= 4096`` and ``S % 1024 == 0`` (no (S, S) scores),
    else the exact form; autograd differentiates it.  A ``meta`` tensor
    goes to the same plain version, as one region forward and one
    backward.  Any other tensor goes to the kernels through
    :class:`FlashAttention`, for any S, which launch or raise.  A
    DTensor raises: under a mesh the caller hands over local shards.
    """
    region.local_only("flash_attention", q, k, v)
    if q.device.type in ("cpu", "meta"):
        s = q.shape[2]
        plain = (ref.blocked_attention if s >= 4096 and s % 1024 == 0
                 else ref.attention)
        if q.device.type == "meta":
            return region.run("flash_attention", lambda *qkv: plain(
                *qkv, causal=causal, window=window), q, k, v)
        return plain(q, k, v, causal=causal, window=window)
    return FlashAttention.apply(q, k, v, causal, window)
