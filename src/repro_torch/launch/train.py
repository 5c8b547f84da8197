"""Train and prefill step factories of the transformer stack.

The counterparts of the reference's ``launch/train.py``, with their
names kept: ``abstract_params``, ``make_sharded_train_step`` (plain SGD
on one device; ``donate`` updates the params in place; its tensor and
FSDP sharding comes with the tensor-parallel slice, ROADMAP),
``make_prefill_step``, ``make_replica_agg_step`` (the eq.-(13)
all-reduce across mesh axes, one rank a shard) and
``make_fl_train_step``, the paper's hierarchical FL on transformers:
every replica takes ``h_local`` local SGD steps, then the eq.-(13) mean
over the replicas runs through ``fedavg_agg``, one launch a round — on
one device, or with a ``pod`` mesh on each rank for its own replicas,
followed by one all-reduce across the pods.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..device import resolve_device
from ..fl.aggregation import (fedavg_stacked, hierarchical_weighted_psum,
                              shard_weighted_aggregate)
from ..models import transformer as T
from ..tree import tree_leaves, tree_map

AGG_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def abstract_params(cfg: ModelConfig):
    """The params' tree with shapes and dtypes only (``meta`` tensors)."""
    return T.init_params(cfg, device="meta")


def _check_batch(batch, shape: InputShape, lead: tuple) -> None:
    want = (*lead, shape.seq_len)
    for key in ("inputs", "labels"):
        got = tuple(batch[key].shape[:len(want)])
        if got != want:
            raise ValueError(f"batch[{key!r}] has shape "
                             f"{tuple(batch[key].shape)}, expected it to "
                             f"start with {want} ({shape.name}: "
                             f"global_batch {shape.global_batch}, seq_len "
                             f"{shape.seq_len})")


def _donated_step(cfg: ModelConfig, lr: float, dev: torch.device):
    """step(params, batch) -> (params, metrics) that writes the update
    into ``params``' own tensors (views included) under ``no_grad``."""
    def step(params, batch):
        grads, metrics = T.loss_and_grads(params, cfg, T.batch_to(batch,
                                                                  dev))
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.copy_(T.sgd_leaf(p, g, lr))
        return params, metrics

    return step


def make_sharded_train_step(cfg: ModelConfig, shape: InputShape,
                            lr: float = 1e-3, donate: bool = True,
                            device="cuda"):
    """Returns step(params, batch) -> (params, metrics) on ``device``.

    Plain SGD (paper eqs. 3-6) for batches of ``shape``: ``inputs`` and
    ``labels`` of (global_batch, seq_len).  ``donate=True`` (the torch
    analogue of ``donate_argnums=(0,)``) updates the given params in
    place and returns them; ``donate=False`` returns new params and
    leaves the given ones untouched.
    """
    dev = resolve_device(device)
    step = (_donated_step(cfg, lr, dev) if donate
            else T.make_train_step(cfg, lr=lr, device=dev))

    def train_step(params, batch):
        _check_batch(batch, shape, (shape.global_batch,))
        return step(params, batch)

    return train_step


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """Forward-only step (inference prefill) on ``device``.

    Returns ``prefill(params, {"inputs": ...}) -> (B, V)`` float32 logits
    of the last position.  Runs under ``torch.no_grad``.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, batch):
        inputs = batch["inputs"].to(dev)
        h, _ = T.forward(params, cfg, inputs)
        # last-token logits only (decode bootstrap)
        logits = T.unembed(params, cfg, h[:, -1:, :])
        return logits[:, 0].to(torch.float32)

    return prefill


def make_replica_agg_step(mesh, axis_names):
    """Standalone eq.-(13) aggregation across mesh axes: returns
    ``agg(tree, lam)``, which every rank calls with its own shard's
    ``tree`` and its one scalar aggregation weight ``lam`` (the weights
    summing to 1 across ``axis_names``); every rank gets the weighted
    sum (:func:`~repro_torch.fl.aggregation.hierarchical_weighted_psum`).
    """
    def agg(tree, lam):
        return hierarchical_weighted_psum(tree, lam, axis_names, mesh)

    return agg


def _pod_size(mesh) -> int:
    """The ``pod`` axis's size; every other axis of ``mesh`` must be 1
    (tensor and FSDP sharding within a pod come with the tensor-parallel
    slice)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        raise ValueError(f"the FL step needs a mesh with a 'pod' axis, got "
                         f"axes {names}")
    for i, name in enumerate(names):
        if name != "pod" and mesh.size(i) != 1:
            raise ValueError(f"mesh axis {name!r} has size {mesh.size(i)}: "
                             f"within a pod the FL step runs on one rank "
                             f"(tensor and FSDP sharding wait for the "
                             f"tensor-parallel slice)")
    return mesh.size(names.index("pod"))


def make_fl_train_step(cfg: ModelConfig, n_replicas: int,
                       shape: InputShape, lr: float = 1e-3,
                       h_local: int = 1, agg_dtype: str = "float32",
                       device="cuda", mesh=None):
    """Per-replica local SGD + the eq.-(13) aggregation over replicas.

    Returns ``fl_round(params_rep, batch) -> (params_rep, metrics)``.
    Every leaf of ``params_rep`` carries a leading replica axis of
    ``n_replicas`` (each replica a satellite-era model), and so does the
    batch: ``inputs`` and ``labels`` of (n_replicas, global_batch /
    n_replicas, seq_len).  Each replica takes ``h_local`` SGD steps on its
    slice, in place in its slot, one replica after another (the
    reference's ``vmap`` computes the same; ``torch.func.vmap`` does not
    pass through the kernels' autograd Functions).  Then the lambda-
    weighted mean with lambda = 1 / n_replicas over the replica axis, in
    ``agg_dtype`` (the reference's ``x.astype(agg_dtype)``), one
    ``fedavg_agg`` call over every leaf (``fedavg_stacked``: one launch
    on the card), is written back into every replica slot, cast to each
    leaf's type.  ``agg_dtype="bfloat16"`` stacks the replicas in bf16
    and rounds the mean to bf16, as the reference's bf16 sum does, within
    one bf16 rounding (the kernel sums the bf16 products in f32).
    ``params_rep`` is updated in place (the reference donates it) and
    returned; metrics are each replica's last step's, averaged over
    replicas.

    With a ``mesh`` whose ``pod`` axis has P ranks (one process a pod,
    every other axis of size 1), each rank holds ``n_replicas / P``
    replicas and its slice of the batch: ``params_rep`` and the batch
    lead with ``n_replicas / P``.  It takes the local steps as above,
    reduces its own replicas through ``fedavg_agg`` with lambda = 1 /
    ``n_replicas`` each, in ``agg_dtype``, and the ranks' partial sums
    meet in one all-reduce over ``pod`` with lambda 1
    (:func:`~repro_torch.fl.aggregation.shard_weighted_aggregate`: a
    float32 aggregate is written by the kernel straight into the
    all-reduce's buffer, so the step holds no second float32 copy of the
    params); the mean goes into every local slot.  Metrics are averaged
    over all ``n_replicas`` replicas across the ranks (a second,
    three-number all-reduce).  ``mesh=None`` is the one-device step
    above, unchanged.
    """
    if agg_dtype not in AGG_DTYPES:
        raise ValueError(f"agg_dtype must be one of {sorted(AGG_DTYPES)}, "
                         f"got {agg_dtype!r}")
    if n_replicas < 1 or shape.global_batch % n_replicas:
        raise ValueError(f"global_batch {shape.global_batch} does not split "
                         f"over {n_replicas} replicas")
    if h_local < 1:
        raise ValueError(f"h_local must be >= 1, got {h_local}")
    dev = resolve_device(device)
    adt = AGG_DTYPES[agg_dtype]
    local_step = _donated_step(cfg, lr, dev)
    weights = [1.0 / n_replicas] * n_replicas
    n_local = n_replicas
    if mesh is not None:
        pods = _pod_size(mesh)
        if n_replicas % pods:
            raise ValueError(f"{n_replicas} replicas do not split over "
                             f"{pods} pods")
        n_local = n_replicas // pods

    def fl_round(params_rep, batch):
        _check_batch(batch, shape, (n_local,
                                    shape.global_batch // n_replicas))
        for leaf in tree_leaves(params_rep):
            if leaf.ndim < 1 or leaf.shape[0] != n_local:
                raise ValueError(f"every leaf needs a leading replica axis "
                                 f"of {n_local}, got shape "
                                 f"{tuple(leaf.shape)}")
        per_replica = []
        for r in range(n_local):
            replica = tree_map(lambda x: x[r], params_rep)
            local = {key: batch[key][r] for key in ("inputs", "labels")}
            for _ in range(h_local):
                replica, metrics = local_step(replica, local)
            per_replica.append(metrics)
        if mesh is None:
            agg = fedavg_stacked(tree_map(lambda x: x.to(adt), params_rep),
                                 weights)
        else:
            agg = _pod_aggregate(params_rep)
        with torch.no_grad():
            for x, a in zip(tree_leaves(params_rep), tree_leaves(agg)):
                x.copy_(a.to(x.dtype).expand_as(x))
        if mesh is None:
            metrics = {key: torch.stack([m[key] for m in per_replica]
                                        ).mean() for key in per_replica[0]}
        else:
            metrics = _pod_metrics(per_replica)
        return params_rep, metrics

    def _pod_aggregate(params_rep):
        """This rank's replicas at lambda 1 / n_replicas each through
        ``fedavg_agg`` (no normalization: the weights are global), then
        the all-reduce over ``pod``."""
        w = torch.full((n_local,), 1.0 / n_replicas, dtype=torch.float32,
                       device=tree_leaves(params_rep)[0].device)
        return shard_weighted_aggregate(
            tree_map(lambda x: x.to(adt), params_rep), w, ("pod",), mesh)

    def _pod_metrics(per_replica):
        keys = sorted(per_replica[0])
        sums = torch.stack([torch.stack([m[k].float() for m in per_replica]
                                        ).sum() for k in keys])
        dist.all_reduce(sums, group=mesh.get_group("pod"))
        return {k: v / n_replicas for k, v in zip(keys, sums)}

    return fl_round
