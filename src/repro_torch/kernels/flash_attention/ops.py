"""Dispatch by device: the CUDA kernels for a CUDA tensor, the plain
PyTorch version for a CPU tensor."""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

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
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  A CPU tensor goes to
    :mod:`.ref`, as the reference dispatches off the TPU: the blocked
    form when ``S >= 4096`` and ``S % 1024 == 0`` (no (S, S) scores),
    else the exact form; autograd differentiates it.  Any other tensor
    goes to the kernels through :class:`FlashAttention`, for any S, which
    launch or raise.
    """
    if q.device.type == "cpu":
        s = q.shape[2]
        if s >= 4096 and s % 1024 == 0:
            return ref.blocked_attention(q, k, v, causal=causal,
                                         window=window)
        return ref.attention(q, k, v, causal=causal, window=window)
    return FlashAttention.apply(q, k, v, causal, window)
