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
reference.  The mesh forms (``hierarchical_weighted_psum``,
``shard_weighted_aggregate``) wait for the multi-GPU slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.fedavg_agg import ops as agg_ops
from ..tree import tree_leaves, tree_map


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


def aggregation_weights(ground_sizes: Sequence[int],
                        air_sizes: Sequence[int],
                        sat_size: int, device="cuda") -> torch.Tensor:
    """lambda weights of eq. (13): portions of the *global* dataset."""
    sizes = torch.as_tensor(list(ground_sizes) + list(air_sizes)
                            + [sat_size], dtype=torch.float32,
                            device=resolve_device(device))
    return sizes / torch.sum(sizes)
