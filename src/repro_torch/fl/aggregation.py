"""Hierarchical model aggregation (eq. 13) and the cross-region merge.

Every weighted average here reduces through the port's ``fedavg_agg``
op, one call per aggregate over all its parameter leaves: the Hopper
kernel (one launch) for CUDA tensors, the plain PyTorch version for CPU
tensors.

1. ``fedavg``               — over a python list of client models.
2. ``fedavg_stacked``       — over stacked client params (leading client
                              axis C).  ``fedavg_stacked_multi`` is its
                              multi-bucket form: the size-bucketed cohort
                              engine's per-bucket stacks go to the op as
                              they are, and it reads each bucket's rows
                              in place (no concatenation).
3. ``fedavg_pytrees``       — stacks per-region models and aggregates
                              them; ``staleness_weighted_merge`` is the
                              cross-region merge on top of it, weighting
                              each region by its data share discounted
                              for model staleness (``2^(-s / half_life)``).

Weights are normalized by their sum before the kernel, as in the
reference.

4. ``hierarchical_weighted_psum`` — eq. (13) across processes: every
                              rank's ``lam * params`` in float32, summed
                              by an all-reduce over each named axis of a
                              ``torch.distributed`` ``DeviceMesh`` in
                              turn (the air-level ``data`` axis, then the
                              space-level ``pod`` axis).
5. ``shard_weighted_aggregate`` — one shard's part of a client-sharded
                              cohort: its clients through ``fedavg_agg``
                              (one launch, the globally normalized
                              weights as given), then that all-reduce.

Both flatten the tree into ONE float32 buffer (each leaf at an offset
aligned to 64 elements, the gaps zero) and all-reduce it in place with
``dist.all_reduce`` (``c10d.allreduce_``, which a ``TorchDispatchMode``
sees): one collective a mesh axis for the whole tree, and no second
float32 copy of it.  ``shard_weighted_aggregate`` has the kernel write
a float32 tree straight into the buffer (its ``out``); the leaves come
back as views of the buffer, cast to each leaf's type.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..kernels.fedavg_agg import ops as agg_ops
from ..tree import tree_leaves, tree_map

# a leaf's offset in the flat all-reduce buffer is a multiple of this many
# elements (256 bytes of float32): the kernel's vector path and NCCL's
# both want aligned rows
FLAT_ALIGN = 64


def _normalized(weights, device) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return w / torch.sum(w)


def fedavg(params_list: List, weights: Sequence[float]):
    """eq. (13) over a python list of client models."""
    stacked = tree_map(lambda *leaves: torch.stack(leaves), *params_list)
    return fedavg_stacked(stacked, weights)


def fedavg_stacked(stacked_params, weights):
    """eq. (13) over stacked params (leading client axis C)."""
    return fedavg_stacked_multi([stacked_params], weights)


def fedavg_stacked_multi(stacked_parts: Sequence, weights):
    """eq. (13) over a sequence of stacked-param trees (one per size
    bucket, leading client axes C_b), every leaf of every bucket in one
    op call.  ``weights`` has length ``sum(C_b)`` in bucket order
    (padding clients carry weight 0)."""
    buckets = [tree_leaves(part) for part in stacked_parts]
    w = _normalized(weights, buckets[0][0].device)
    out = iter(agg_ops.aggregate(buckets, w))
    return tree_map(lambda _: next(out), stacked_parts[0])


def client_finite_mask(stacked_params) -> torch.Tensor:
    """Per-client finiteness over stacked params (leading client axis C):
    a boolean ``(C,)`` vector, ``True`` where every leaf element of that
    client's model is finite."""
    masks = [torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(dim=1)
             for leaf in tree_leaves(stacked_params)]
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def tree_all_finite(params) -> bool:
    """Host-side: True when every leaf element of ``params`` is finite
    (forces a device sync)."""
    return all(bool(torch.isfinite(leaf).all())
               for leaf in tree_leaves(params))


def fedavg_pytrees(params_list: List, weights):
    """eq. (13) over a python list of models through the stacked path:
    stacks the models along a leading axis and aggregates them with
    float32 weights.  A single-model "merge" is the identity."""
    if len(params_list) == 1:
        return params_list[0]
    return fedavg(params_list, weights)


def staleness_merge_weights(sizes: Sequence[float],
                            staleness: Sequence[float],
                            half_life: Optional[float] = None) -> np.ndarray:
    """Normalized cross-region merge weights.

    ``weight_i ∝ sizes_i * 2^(-staleness_i / half_life)``: the data-share
    lambda of eq. (13) lifted to whole regions, discounted for the age of
    each region's model at the merge instant.  ``half_life=None`` (or
    ``inf``) disables the discount — pure data-share FedAvg.

    Edge semantics:

    * ``half_life=0`` is a HARD cutoff: only the freshest models (those
      at the minimum staleness — age 0 at a barrier) keep weight.
    * If the discount drives EVERY weight to zero (all models many
      half-lives stale, ``exp2`` underflow), the weights renormalize
      over the freshest models' data shares instead of emitting
      zero/NaN weights — a merge always redistributes unit mass.
    """
    w = np.asarray(sizes, dtype=np.float64)
    if np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"region sizes must be non-negative with positive "
                         f"total, got {list(sizes)}")
    s = np.asarray(staleness, dtype=np.float64)
    if s.shape != w.shape:
        raise ValueError(f"sizes/staleness length mismatch: "
                         f"{w.shape} vs {s.shape}")
    if np.any(s < 0):
        raise ValueError(f"staleness must be non-negative, got {list(s)}")
    if half_life is not None and np.isfinite(half_life):
        if half_life < 0:
            raise ValueError(f"half_life must be non-negative, "
                             f"got {half_life}")
        if half_life == 0:
            w = np.where(s == s.min(), w, 0.0)
        else:
            w = w * np.exp2(-s / half_life)
    if w.sum() <= 0:
        # all-stale underflow: fall back to data shares over the
        # freshest model(s); if those hold no data, to plain data shares
        w = np.where(s == s.min(), np.asarray(sizes, np.float64), 0.0)
        if w.sum() <= 0:
            w = np.asarray(sizes, np.float64)
    return w / w.sum()


def staleness_weighted_merge(params_list: List, sizes: Sequence[float],
                             staleness: Sequence[float],
                             half_life: Optional[float] = None,
                             return_weights: bool = False):
    """Merge per-region models into ONE global model with
    :func:`staleness_merge_weights` through :func:`fedavg_pytrees`.
    ``return_weights=True`` additionally returns the realized weights."""
    if len(params_list) != len(list(sizes)):
        raise ValueError(f"{len(params_list)} models but "
                         f"{len(list(sizes))} sizes")
    w = staleness_merge_weights(sizes, staleness, half_life)
    merged = fedavg_pytrees(params_list, w)
    return (merged, w) if return_weights else merged


def _flat_buffer(shapes, device):
    """One zeroed float32 buffer holding a tree's leaves of ``shapes``,
    and a view of it for each: (buffer, views)."""
    offsets, at = [], 0
    for shape in shapes:
        offsets.append(at)
        n = math.prod(shape)
        at += -(-n // FLAT_ALIGN) * FLAT_ALIGN
    flat = torch.zeros(at, dtype=torch.float32, device=device)
    views = [flat[o:o + math.prod(s)].view(s)
             for o, s in zip(offsets, shapes)]
    return flat, views


def _all_reduce(flat: torch.Tensor, axis_names: Sequence[str], mesh
                ) -> None:
    """Sum ``flat`` in place over each of ``mesh``'s ``axis_names``, in
    order."""
    if mesh is None:
        raise ValueError("a mesh-native aggregate needs a DeviceMesh; "
                         "one process aggregates with fedavg_stacked")
    for ax in axis_names:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(ax))


def _unflatten(views, like):
    """``like``'s tree with each leaf the matching view, cast to the
    leaf's type (float32 leaves are the views themselves)."""
    out = iter(v.to(x.dtype) for v, x in zip(views, tree_leaves(like)))
    return tree_map(lambda _: next(out), like)


def hierarchical_weighted_psum(local_params, lam, axis_names, mesh):
    """Mesh-native eq. (13): weighted sum over one or more mesh axes.

    Every rank calls it with its own ``local_params`` and its own
    aggregation weight ``lam`` (its data portion; the weights sum to 1
    across the axes).  Each leaf becomes ``lam * leaf`` in float32, is
    all-reduced over ``mesh.get_group(ax)`` for each ``ax`` of
    ``axis_names`` in order, and is cast back to its type.  Every rank
    returns the same tree.
    """
    leaves = tree_leaves(local_params)
    flat, views = _flat_buffer([tuple(x.shape) for x in leaves],
                               leaves[0].device)
    for v, x in zip(views, leaves):
        v.copy_(x)
    flat.mul_(lam)
    _all_reduce(flat, axis_names, mesh)
    return _unflatten(views, local_params)


def shard_weighted_aggregate(stacked_params, weights, axis_names=("data",),
                             mesh=None):
    """In-mesh eq. (13) over a SHARD of stacked client params.

    ``stacked_params`` is this rank's slice of the client-stacked tree
    (leading axis ``C_shard``) and ``weights`` its slice of the GLOBALLY
    normalized client weights (padding clients carry weight 0, so the
    full-axis weights sum to 1): no normalization here.  The shard
    reduces its clients through ``fedavg_agg`` (one launch on the card),
    then the partial sums combine across ``axis_names`` by
    :func:`hierarchical_weighted_psum`'s all-reduce.
    """
    return shard_weighted_aggregate_multi([stacked_params], weights,
                                          axis_names, mesh)


def shard_weighted_aggregate_multi(stacked_parts: Sequence, weights,
                                   axis_names=("data",), mesh=None):
    """:func:`shard_weighted_aggregate` over a sequence of stacked trees
    (this shard's block of every size bucket, leading axes C_b): every
    leaf of every block in ONE ``fedavg_agg`` call, ``weights`` the
    shard's (sum C_b,) slice in bucket order, then one all-reduce."""
    buckets = [tree_leaves(part) for part in stacked_parts]
    first = buckets[0]
    flat, views = _flat_buffer([tuple(x.shape[1:]) for x in first],
                               first[0].device)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=first[0].device)
    if first[0].dtype == torch.float32:
        agg_ops.aggregate(buckets, w, out=views)
    else:
        for v, o in zip(views, agg_ops.aggregate(buckets, w)):
            v.copy_(o)
    # lam = 1: the partial sums are already weighted
    _all_reduce(flat, axis_names, mesh)
    return _unflatten(views, tree_map(lambda x: x[0], stacked_parts[0]))


def aggregation_weights(ground_sizes: Sequence[int],
                        air_sizes: Sequence[int],
                        sat_size: int, device="cuda") -> torch.Tensor:
    """lambda weights of eq. (13): portions of the *global* dataset."""
    sizes = torch.as_tensor(list(ground_sizes) + list(air_sizes)
                            + [sat_size], dtype=torch.float32,
                            device=resolve_device(device))
    return sizes / torch.sum(sizes)
