"""Activation sharding constraints (MaxText-style), on DTensor.

The counterpart of the reference's ``sharding/activations.py``.  With the
params and the batch placed as DTensors (``specs.distribute_params``),
DTensor's propagation is free to re-shard intermediate activations, which
bloats memory and collectives; the model code therefore pins key
activations with ``shard(x, ...)``, a no-op unless a mesh context has
been installed with ``set_activation_sharding`` (one device skips it
entirely, and so does a tensor that is not a DTensor).

Spec tokens: ``"batch"`` -> the (pod, data) batch axes of the installed
context (none for batch-1 decode: the dim is then replicated),
``"model"`` -> the tensor axis, ``None`` -> replicated, as ``None`` is
in the reference's ``PartitionSpec``.

A pin also constrains the gradient to the same placements, as a
cotangent is constrained under the reference's
``with_sharding_constraint``.  Besides ``shard``, the helpers the model
code needs under a mesh: ``gather_fsdp`` (a block's weights
all-gathered over the FSDP axes before use; its backward
reduce-scatters the gradients), ``local_call`` (a hand-written kernel,
or an op DTensor has no rule for, run on each rank's local shards) and
``write_slot`` (one decode step's write into a cache whose sequence dim
may be split).  The layers record how their heads and experts sat on
the ``model`` axis (``note_layout``), which the dry run reports.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Sequence, Tuple

import torch

_CTX = {"mesh": None, "batch_axes": (), "layouts": {}}


def set_activation_sharding(mesh, batch_axes: Tuple[str, ...]):
    _CTX["mesh"] = mesh
    _CTX["batch_axes"] = tuple(batch_axes)
    _CTX["layouts"] = {}


def clear_activation_sharding():
    _CTX["mesh"] = None
    _CTX["batch_axes"] = ()


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: Tuple[str, ...]):
    set_activation_sharding(mesh, batch_axes)
    try:
        yield
    finally:
        clear_activation_sharding()


def current_mesh():
    """The installed mesh, or ``None``."""
    return _CTX["mesh"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements_for(entries: Sequence, mesh):
    """DTensor placements, one per mesh dim, of spec ``entries`` (one per
    tensor dim: ``None``, an axis name or a tuple of names): ``Shard(i)``
    on each mesh dim that entry ``i`` names, ``Replicate()`` elsewhere.
    An axis the mesh lacks is dropped (the reference's specs name
    ``pod`` on meshes without it only through ``batch_axes``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(entries):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in names:
                out[names.index(axis)] = Shard(i)
    return out


def _entries(spec) -> list:
    batch = _CTX["batch_axes"]
    return [(batch if batch else None) if s == "batch" else s for s in spec]


class _Pin(torch.autograd.Function):
    """``x`` brought to ``want``, and its gradient brought to ``want``
    too: the cotangent takes the same constraint, as under the
    reference's ``with_sharding_constraint``.  Without it a gradient may
    stay a partial sum, and DTensor then gathers a split weight to
    multiply it, every rank doing the whole product."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


def shard(x, *spec):
    """Constrain ``x`` (and its gradient); tokens: ``"batch"``,
    ``"model"``, ``None``."""
    mesh = _CTX["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    want = tuple(placements_for(_entries(spec), mesh))
    if torch.is_grad_enabled() and x.requires_grad:
        return _Pin.apply(x, mesh, want)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def gather_fsdp(tree):
    """Every DTensor leaf of ``tree`` with its placements on the mesh dims
    other than ``model`` made ``Replicate()``: the FSDP all-gather of a
    block's weights before the block runs (under remat, again in its
    recompute).  Its backward reduce-scatters each gradient back to the
    leaf's own placements.  A no-op without a context."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return tree
    from torch.distributed.tensor import Replicate
    names = tuple(mesh.mesh_dim_names)

    def gather(x):
        if not is_dtensor(x):
            return x
        want = [p if n == "model" else Replicate()
                for n, p in zip(names, x.placements)]
        return x if want == list(x.placements) else x.redistribute(
            mesh, want)

    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_fsdp(v) for v in tree)
    return gather(tree)


def axis_size(name: str) -> int:
    """The installed mesh's size along ``name`` (1 when absent)."""
    mesh = _CTX["mesh"]
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def local_call(fn: Callable, args: Sequence, in_specs: Sequence[Sequence],
               out_specs, partial_grads: Sequence[Sequence[str]] = (),
               out_partial: Sequence[str] = ()):
    """``fn`` on each rank's local shards of the DTensors ``args``, with
    the results placed by ``out_specs`` (one spec, or a tuple of specs for
    a tuple of results); without a context, ``fn(*args)`` itself.  Each argument is first brought to its spec of
    ``in_specs`` (tokens as for :func:`shard`).  The hand-written kernels'
    autograd Functions run inside, so their backward kernels see the local
    shards too.

    ``partial_grads[i]`` names the mesh axes over which argument ``i``'s
    gradient is a partial sum: an axis on which the argument is whole but
    each rank uses only a part of it (its batch rows, its experts, its
    kv head).  Elsewhere a gradient takes its argument's placements.
    ``out_partial`` names the axes over which every result is a partial
    sum (each model rank's experts, say).  Results, and the gradients
    handed back, are made contiguous: DTensor's ops view a shard where
    plain tensors would copy."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    names = tuple(mesh.mesh_dim_names)

    def placed(spec, partial=()):
        return tuple(Partial() if n in partial else p for n, p in
                     zip(names, placements_for(_entries(spec), mesh)))

    grads = list(partial_grads) + [()] * (len(args) - len(partial_grads))
    many = bool(out_specs) and isinstance(out_specs[0], (tuple, list))
    out_pl = tuple(placed(o, out_partial)
                   for o in (out_specs if many else (out_specs,)))

    def contiguous_fn(*local):
        out = fn(*contiguous_grads(*local))
        return (tuple(o.contiguous() for o in out)
                if isinstance(out, tuple) else out.contiguous())

    mapped = local_map(
        contiguous_fn, out_placements=out_pl,
        in_placements=tuple(placed(s) for s in in_specs),
        in_grad_placements=tuple(placed(s, g)
                                 for s, g in zip(in_specs, grads)),
        device_mesh=mesh, redistribute_inputs=True)
    return mapped(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grads(*xs):
    """``xs`` as they are, with contiguous gradients."""
    return tuple(_ContiguousGrad.apply(x) if x.requires_grad else x
                 for x in xs)


def batch_split_axes() -> Tuple[str, ...]:
    """The installed batch axes (empty without a context)."""
    return _CTX["batch_axes"]


def note_layout(what: str, layout: str, **shape) -> None:
    """Record how ``what`` sat on the mesh (read by the dry run); a no-op
    without a context."""
    if _CTX["mesh"] is None:
        return
    _CTX["layouts"][f"{what}:{layout}"] = dict(shape, layout=layout)


def layouts() -> dict:
    """The layouts recorded since the context was installed."""
    return dict(_CTX["layouts"])


def write_slot(buf, dim: int, slot: int, value) -> None:
    """``buf.select(dim, slot).copy_(value)`` under ``no_grad``, for a
    plain tensor or a DTensor whose ``dim`` may be split over mesh dims
    (the sequence-parallel decode cache): only the rank that holds
    position ``slot`` writes it, into its local shard in place.  ``value``
    has ``buf``'s shape without ``dim``; as a DTensor it is brought to
    ``buf``'s placements on the other dims first."""
    if not is_dtensor(buf):
        buf.select(dim, slot).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = buf.device_mesh
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    # value's placements: buf's with ``dim`` dropped (dims after it shift)
    want = []
    for p in buf.placements:
        if isinstance(p, Shard) and p.dim == dim:
            want.append(Replicate())
        elif isinstance(p, Shard) and p.dim > dim:
            want.append(Shard(p.dim - 1))
        else:
            want.append(p)
    if is_dtensor(value):
        if tuple(value.placements) != tuple(want):
            value = value.redistribute(mesh, want)
        value = value.to_local()
    lo = offset[dim]
    if lo <= slot < lo + shape[dim]:
        buf.to_local().select(dim, slot - lo).copy_(value.to(buf.dtype))


def batch_spec_axes(mesh, batch: int) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` (``pod`` then ``data``, those present)
    that a batch of ``batch`` rows splits over evenly, the largest such
    set; ``()`` when it splits over none."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(a for a in ("pod", "data") if a in names)
    for cut in range(len(axes)):
        n = 1
        for a in axes[cut:]:
            n *= mesh.size(names.index(a))
        if batch % n == 0:
            return axes[cut:]
    return ()


def to_global(x) -> torch.Tensor:
    """The full value of a DTensor (all-gathered), or ``x`` itself."""
    return x.full_tensor() if is_dtensor(x) else x
