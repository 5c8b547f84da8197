"""The kernels' stand-in on the ``meta`` device: the plain version, run as
one region.

A ``meta`` tensor has a shape and a dtype and no storage: the dry-run
(``launch/dryrun.py``) runs the port's steps on such tensors to count
their work.  The three dispatchers send a ``meta`` tensor to their
kernel's plain version through :func:`run`, which runs it as one region,
and under autograd its backward as another.  A ``meta`` tensor computes
nothing, so this hides no device: a CUDA tensor still goes to the kernel.

Whoever counts (``launch/op_analysis.py``) listens through
:data:`LISTENERS`: inside a region the matmuls are the plain version's
(the work the kernel does), and the bytes are the kernel's own, every
input read once and every output written once, as XLA counts a fusion or
a custom call at its call site.  Without a listener a region only runs
the plain version.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

# Objects with ``enter_region(name)`` and ``exit_region(name, read,
# written)``, the tensors the region reads and writes
LISTENERS: List = []


def _region(name: str, fn: Callable, read: Sequence[torch.Tensor]):
    for listener in LISTENERS:
        listener.enter_region(name)
    out = fn()
    written = list(out) if isinstance(out, (list, tuple)) else [out]
    for listener in reversed(LISTENERS):
        listener.exit_region(name, list(read), written)
    return out


class _Plain(torch.autograd.Function):
    """The plain version as one region forward and one backward.  The
    forward keeps the plain version's own graph (built on detached
    inputs), and the backward runs autograd through it: its work is the
    plain version's backward, once, as the reference's autodiff does."""

    @staticmethod
    def forward(ctx, name, fn, *inputs):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(x.requires_grad)
                      for x in inputs]
            out = _region(name, lambda: fn(*leaves), leaves)
        ctx.name, ctx.leaves, ctx.out = name, leaves, out
        return out.detach()

    @staticmethod
    def backward(ctx, dout):
        wanted = [x for x in ctx.leaves if x.requires_grad]
        grads = iter(_region(
            ctx.name + "_backward",
            lambda: torch.autograd.grad(ctx.out, wanted, dout,
                                        allow_unused=True),
            [*ctx.leaves, ctx.out, dout]))
        return (None, None, *(next(grads) if x.requires_grad else None
                              for x in ctx.leaves))


def run(name: str, fn: Callable, *inputs: torch.Tensor):
    """``fn(*inputs)``, the plain version of kernel ``name``, as a region;
    differentiable through :class:`_Plain` where grad is on and an input
    requires it."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _Plain.apply(name, fn, *inputs)
    return _region(name, lambda: fn(*inputs), inputs)


def local_only(name: str, *tensors) -> None:
    """Raise unless every tensor is a plain one: a DTensor has no storage
    of its own to hand a kernel, so a dispatcher takes its local shards
    (``sharding.activations.local_call``), never the DTensor."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes plain tensors: run it on each "
                        f"rank's local shards (sharding.activations."
                        f"local_call), not on a DTensor")
