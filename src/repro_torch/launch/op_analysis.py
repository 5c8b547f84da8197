"""Cost analysis of a step as PyTorch dispatches it, on any device.

The counterpart of the reference's ``launch/hlo_analysis.py``, which
parses compiled HLO.  Here ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` and counts every ATen op it dispatches, forward and
backward, with the reference's counting rules:

  * flops: matmul-class ops only (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolution forward and backward): 2 * result *
    contracted size.  Elementwise flops are ignored.
  * bytes: operand + result bytes of every op that materializes.  Views,
    ``empty`` and metadata ops are free.  As in the reference, a gather
    (``embedding``, ``index_select``, ``gather``, indexing) reads only
    what it returns, and an in-place window write (``index_put_``,
    ``index_copy_``, the scatters of a slice) moves twice its update, not
    the buffer it writes into.
  * collectives: the result bytes of each collective op on this rank,
    by the reference's kinds (``all-reduce``, ``all-gather``,
    ``reduce-scatter``; ``launch/dryrun.py``'s ``collective_bytes``),
    for the functional collectives (``_c10d_functional``) and the
    in-place ``torch.distributed`` ones (``c10d``) alike.  They count as
    collective bytes only, not as memory traffic.  One device dispatches
    none; a ``"fake"`` process group runs a mesh step on ``meta``.

Eager PyTorch dispatches every iteration of a Python loop, so nothing
needs scaling by trip counts (the reference multiplies ``while`` bodies
by theirs); backward and ``torch.utils.checkpoint`` recompute are
counted as dispatched, as XLA's remat is.  On the ``meta`` device
nothing is computed, so a full-size step is counted without the card.

A step on a mesh runs on DTensors (``launch/train.py``), and an op on
DTensors is counted where DTensor runs it: on each rank's local shards,
with the collectives its redistributions dispatch.  The counter lets
DTensor take the op (it declines it at the global shapes), then counts
the local ops DTensor dispatches under it; the fake tensors DTensor's
sharding propagation runs on are not counted.  So every count is per
device, as the reference's per-device HLO is.

A hand-written kernel's stand-in on ``meta`` is its plain version, run
as one region (``kernels/region.py``): its matmuls count as the plain
version's, its bytes as the kernel's own (inputs read once, outputs
written once), as XLA counts a fusion or a custom call at its call site.

``library_cost`` is PyTorch's own count (``FlopCounterMode``), the
counterpart of ``xla_cost``: a second opinion, reported beside this
one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels import region

aten = torch.ops.aten

_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.resolve_conj.default,
         aten.resolve_neg.default, aten.is_same_size.default,
         aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
         aten.sym_storage_offset.default}
_GATHERS = {aten.embedding.default, aten.index_select.default,
            aten.gather.default, aten.index.Tensor}
_WINDOW_WRITES = {aten.index_put.default, aten.index_put_.default,
                  aten.index_copy.default, aten.index_copy_.default,
                  aten.slice_scatter.default, aten.select_scatter.default}


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def _nbytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def _conv_flops(x, w, out_numel: int, transposed: bool) -> float:
    """2 * the products of one convolution: every output element of a
    plain one takes ``w.shape[1] * kernel size`` of them, and so does
    every input element of a transposed one (its weight is (C_in,
    C_out / groups, ...))."""
    per = w.shape[1] * _numel(w.shape[2:])
    return 2.0 * (x.numel() if transposed else out_numel) * per


def matmul_flops(func, args, out) -> float:
    """FLOPs of one ATen op under the counting rules (0 unless it is a
    matmul-class op)."""
    if func in (aten.mm.default, aten.bmm.default):
        a = args[0]
    elif func in (aten.addmm.default, aten.baddbmm.default):
        a = args[1]
    elif func is aten.convolution.default:
        return _conv_flops(args[0], args[1], out.numel(), args[6])
    elif func is aten.convolution_backward.default:
        # grad_output, input, weight, ..., transposed (7), ..., mask (10):
        # the input's and the weight's gradients each cost the forward
        fwd = _conv_flops(args[1], args[2], args[0].numel(), args[7])
        return fwd * sum(bool(m) for m in args[10][:2])
    else:
        return 0.0
    return 2.0 * out.numel() * a.shape[-1]


def _collective_kinds():
    """ATen collective op -> the reference's kind, for the ops this build
    of torch registers."""
    names = {
        "_c10d_functional": {
            "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
            "all_reduce_coalesced": "all-reduce",
            "all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_coalesced": "all-gather",
            "reduce_scatter_tensor": "reduce-scatter",
            "reduce_scatter_tensor_coalesced": "reduce-scatter"},
        "c10d": {
            "allreduce_": "all-reduce",
            "allreduce_coalesced_": "all-reduce",
            "allgather_": "all-gather",
            "_allgather_base_": "all-gather",
            "allgather_into_tensor_coalesced_": "all-gather",
            "reduce_scatter_": "reduce-scatter",
            "_reduce_scatter_base_": "reduce-scatter",
            "reduce_scatter_tensor_coalesced_": "reduce-scatter"}}
    out = {}
    for ns, ops in names.items():
        space = getattr(torch.ops, ns)
        for name, kind in ops.items():
            try:
                out[getattr(space, name).default] = kind
            except (AttributeError, RuntimeError):
                pass   # not in this build
    return out


_COLLECTIVES = _collective_kinds()
# the functional collectives' bookkeeping ops (waits, autograd wrappers)
_FREE_NAMESPACES = {"_c10d_functional", "_c10d_functional_autograd",
                    "c10d"}




def collective_bytes(func, args, out) -> float:
    """The per-rank result bytes of one collective op: what an in-place
    op writes into its outputs (its first argument: a tensor or a list
    of them; for ``allgather_`` the output lists), or what a functional
    one returns."""
    if func.namespace == "c10d":
        return float(sum(_nbytes(t) for t in tree_leaves(args[0])))
    return float(sum(_nbytes(t) for t in tree_leaves(out)))


def _op_bytes(func, args, kwargs, out) -> float:
    if func in _FREE or func.is_view:
        return 0.0
    operands = [_nbytes(t) for t in tree_leaves((args, kwargs))]
    result = sum(_nbytes(t) for t in tree_leaves(out))
    if func in _GATHERS:
        # a read of the rows it returns (plus the indices), not the table
        return result + sum(b for b in operands if b < result)
    if func in _WINDOW_WRITES:
        small = [b for b in operands if 0 < b < result]
        return 2 * (min(small) if small else result)
    return result + sum(operands)


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(default_factory=dict)

    def scaled(self, k: float) -> "Costs":
        return Costs(self.flops * k, self.bytes * k,
                     {n: v * k for n, v in self.collectives.items()})

    def add(self, other: "Costs"):
        self.flops += other.flops
        self.bytes += other.bytes
        for n, v in other.collectives.items():
            self.collectives[n] = self.collectives.get(n, 0.0) + v

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())


class _Counter(TorchDispatchMode):
    """Counts every dispatched op into ``costs``; inside a kernel region
    (``kernels/region.py``) only the flops, the region's own bytes on
    exit."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.depth = 0

    def enter_region(self, name: str) -> None:
        self.depth += 1

    def exit_region(self, name: str, read: Sequence, written: List) -> None:
        self.depth -= 1
        if self.depth == 0:
            self.costs.bytes += sum(_nbytes(t) for t in (*read, *written))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = tree_leaves((args, kwargs))
        if any(isinstance(t, DTensor) for t in leaves):
            return NotImplemented      # counted at DTensor's local ops
        out = func(*args, **kwargs)
        if func.namespace in _FREE_NAMESPACES or any(
                isinstance(t, FakeTensor) for t in leaves):
            if _COLLECTIVES.get(func) is None:
                return out             # sharding propagation, or a wait
        kind = _COLLECTIVES.get(func)
        if kind is not None:
            c = self.costs.collectives
            c[kind] = c.get(kind, 0.0) + collective_bytes(func, args, out)
            return out
        self.costs.flops += matmul_flops(func, args, out)
        if self.depth == 0:
            self.costs.bytes += _op_bytes(func, args, kwargs, out)
        return out


def analyze(fn, *args, **kw) -> Costs:
    """Costs of ``fn(*args, **kw)`` as dispatched, backward included if
    ``fn`` runs it.  On ``meta`` tensors nothing is computed."""
    counter = _Counter()
    region.LISTENERS.append(counter)
    try:
        with counter:
            fn(*args, **kw)
    finally:
        region.LISTENERS.remove(counter)
    return counter.costs


def library_cost(fn, *args, **kw) -> Dict[str, float]:
    """PyTorch's own FLOP count of ``fn(*args, **kw)``
    (``torch.utils.flop_counter.FlopCounterMode``), as a flat dict like
    the reference's ``xla_cost``.  It counts no bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args, **kw)
    return {"flops": float(mode.get_total_flops())}


def analyze_with_library(fn, *args, **kw) -> Tuple[Costs, Dict[str, float]]:
    """:func:`analyze` and :func:`library_cost` of one run of ``fn``, the
    two modes stacked.  This module's mode is the inner one, so it sees
    every op as dispatched, before ``FlopCounterMode`` decomposes any."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = FlopCounterMode(display=False)
    with mode:
        costs = analyze(fn, *args, **kw)
    return costs, {"flops": float(mode.get_total_flops())}
