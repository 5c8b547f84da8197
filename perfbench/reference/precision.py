"""The precisions the references compute in.

``exact()`` turns TF32 off for matrix products and convolutions while a
reference runs (PyTorch's cuDNN runs float32 convolutions on TF32 unless
told otherwise) and restores the flags after.

A product computed in a lower precision rounds its operands, in the
forward and in the backward: :func:`operand` rounds an input of a
product (the gradient passes through it unchanged), and :func:`result`
wraps the product's output so that the gradient arriving at it is
rounded before the backward's products use it.  ``"fp8"`` scales by the
tensor's largest magnitude to float8 e4m3's range (inputs) or e5m2's
(gradients), rounds, and scales back (the usual fp8 training recipe).
``None`` leaves everything in float32.  Accumulation stays float32, as
on the tensor cores.
"""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def exact():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / torch.clamp(x.detach().abs().amax().float(), min=1e-30)
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def _round(x: torch.Tensor, precision, grad: bool) -> torch.Tensor:
    if precision == "fp8":
        if grad:
            return _fp8(x, torch.float8_e5m2, E5M2_MAX)
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)
    raise ValueError(f"unknown precision {precision!r}")


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        return _round(x, precision, grad=False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Result(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, precision):
        ctx.precision = precision
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision, grad=True), None


def operand(x: torch.Tensor, precision) -> torch.Tensor:
    """``x`` rounded as an input of a product in ``precision``."""
    return x if precision is None else _Operand.apply(x, precision)


def result(y: torch.Tensor, precision) -> torch.Tensor:
    """``y``, a product's output, whose gradient is rounded as an input
    of the backward's products in ``precision``."""
    return y if precision is None else _Result.apply(y, precision)
