"""Train and prefill step factories of the transformer stack.

The counterparts of the reference's ``launch/train.py``, with their
names kept: ``abstract_params``, ``make_sharded_train_step`` (plain SGD;
``donate`` updates the params in place), ``make_prefill_step``,
``make_replica_agg_step`` (the eq.-(13) all-reduce across mesh axes, one
rank a shard) and ``make_fl_train_step``, the paper's hierarchical FL on
transformers: every replica takes ``h_local`` local SGD steps, then the
eq.-(13) mean over the replicas runs through ``fedavg_agg``, one launch
a round — on one device, or with a ``pod`` mesh on each rank for its own
replicas, followed by one all-reduce across the pods.

With a ``mesh`` (a ``DeviceMesh`` with ``data`` and ``model`` axes, and
``pod``), the train and prefill steps are data + tensor parallel with
FSDP weights on DTensor: the params are DTensors placed by
``param_pspecs`` (``step.place(params)``), the batch is split over the
batch axes, activations are pinned by ``sharding.activations.shard``,
and the hand-written kernels run on each rank's local shards.  One
process is one device of the mesh.  ``mesh=None`` is the one-device
path, unchanged.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..device import resolve_device
from ..fl.aggregation import (fedavg_stacked, hierarchical_weighted_psum,
                              shard_weighted_aggregate)
from ..models import transformer as T
from ..sharding import activations as A
from ..sharding.specs import (PartitionSpec, distribute_params,
                              param_pspecs, placements, redistribute_to)
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
    into ``params``' own tensors (views included) under ``no_grad``.
    Under a mesh a gradient is brought to its param's placements first,
    and the update runs on the local shards."""
    def step(params, batch):
        grads, metrics = T.loss_and_grads(params, cfg, T.batch_to(batch,
                                                                  dev))
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                if A.is_dtensor(p):
                    if tuple(g.placements) != tuple(p.placements):
                        g = g.redistribute(p.device_mesh, p.placements)
                    p, g = p.to_local(), g.to_local()
                p.copy_(T.sgd_leaf(p, g, lr))
        return params, metrics

    return step


@contextlib.contextmanager
def on_mesh(mesh, batch_axes):
    """The context a step runs in under ``mesh``: the activation specs
    installed, and plain tensors (positions, masks) taken as replicated
    where they meet DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    with A.activation_sharding(mesh, batch_axes), implicit_replication():
        yield


def place_batch(batch, mesh, batch_axes, keys=("inputs", "labels")):
    """A batch given whole on every rank (or as DTensors) split over
    ``batch_axes`` on ``mesh``: each rank keeps its rows."""
    from torch.distributed.tensor import distribute_tensor
    spec = placements(PartitionSpec(batch_axes or None), mesh)
    out = {}
    for key in keys:
        x = batch[key]
        out[key] = x if A.is_dtensor(x) else distribute_tensor(
            x, mesh, spec, src_data_rank=None)
    return out


def replicated(metrics):
    """Metrics as plain tensors, whole on every rank."""
    return {k: A.to_global(v) for k, v in metrics.items()}


def make_sharded_train_step(cfg: ModelConfig, shape: InputShape,
                            lr: float = 1e-3, donate: bool = True,
                            device="cuda", mesh=None, fsdp: bool = True,
                            pod_shard_params: bool = False):
    """Returns step(params, batch) -> (params, metrics) on ``device``.

    Plain SGD (paper eqs. 3-6) for batches of ``shape``: ``inputs`` and
    ``labels`` of (global_batch, seq_len).  ``donate=True`` (the torch
    analogue of ``donate_argnums=(0,)``) updates the given params in
    place and returns them; ``donate=False`` returns new params and
    leaves the given ones untouched.

    With ``mesh``: the params are DTensors placed by ``param_pspecs(cfg,
    ..., fsdp, pod_shard_params)`` (``step.place(params)`` places a full
    tree), the batch (whole on every rank, or DTensors) is split over the
    batch axes, and the metrics come back whole on every rank.  The
    update runs on each rank's local shards.
    """
    dev = resolve_device(device)
    step = (_donated_step(cfg, lr, dev) if donate
            else T.make_train_step(cfg, lr=lr, device=dev))
    if mesh is None:
        def train_step(params, batch):
            _check_batch(batch, shape, (shape.global_batch,))
            return step(params, batch)

        return train_step

    axes = A.batch_spec_axes(mesh, shape.global_batch)
    pspecs = param_pspecs(cfg, abstract_params(cfg), fsdp=fsdp,
                          pod_shard_params=pod_shard_params)

    def train_step(params, batch):
        _check_batch(batch, shape, (shape.global_batch,))
        with on_mesh(mesh, axes):
            params, metrics = step(params, place_batch(batch, mesh, axes))
            if not donate:
                params = tree_map(lambda p, s: redistribute_to(p, mesh, s), params,
                                  pspecs)
        return params, replicated(metrics)

    train_step.pspecs = pspecs
    train_step.place = lambda params: distribute_params(params, mesh, pspecs)
    return train_step


def make_prefill_step(cfg: ModelConfig, device="cuda", mesh=None,
                      shape: InputShape = None):
    """Forward-only step (inference prefill) on ``device``.

    Returns ``prefill(params, {"inputs": ...}) -> (B, V)`` float32 logits
    of the last position.  Runs under ``torch.no_grad``.  With ``mesh``
    the params are DTensors placed by ``param_pspecs`` (``prefill.place``)
    and the batch splits over the batch axes that ``shape``'s batch (or,
    without ``shape``, the given batch) divides; the logits are a DTensor
    split over the batch axes, whole over ``model``.
    """
    dev = resolve_device(device)

    def last_logits(params, inputs):
        h, _ = T.forward(params, cfg, inputs)
        # last-token logits only (decode bootstrap)
        logits = T.unembed(params, cfg, h[:, -1:, :])
        return logits[:, 0].to(torch.float32)

    if mesh is None:
        @torch.no_grad()
        def prefill(params, batch):
            return last_logits(params, batch["inputs"].to(dev))

        return prefill

    pspecs = param_pspecs(cfg, abstract_params(cfg))

    @torch.no_grad()
    def prefill(params, batch):
        b = shape.global_batch if shape is not None else (
            batch["inputs"].shape[0])
        axes = A.batch_spec_axes(mesh, b)
        with on_mesh(mesh, axes):
            inputs = place_batch(batch, mesh, axes, ("inputs",))["inputs"]
            return A.shard(last_logits(params, inputs), "batch", None)

    prefill.pspecs = pspecs
    prefill.place = lambda params: distribute_params(params, mesh, pspecs)
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


def _pod_split(mesh):
    """``(pods, inner)``: the ``pod`` axis's size, and the mesh of the
    other axes (``data`` x ``model``) a replica is sharded over inside
    its pod — ``None`` where those axes are all of size 1 (a replica then
    sits whole on its rank, as plain tensors)."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        raise ValueError(f"the FL step needs a mesh with a 'pod' axis, got "
                         f"axes {names}")
    rest = tuple(n for n in names if n != "pod")
    wide = [n for n in rest if mesh.size(names.index(n)) > 1]
    return mesh.size(names.index("pod")), (mesh[rest] if wide else None)


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

    With a ``mesh`` whose ``pod`` axis has P entries, each pod holds
    ``n_replicas / P`` replicas and its slice of the batch: ``params_rep``
    and the batch lead with ``n_replicas / P``.  Inside a pod a replica
    is sharded over the other axes (``data`` x ``model``) as in
    :func:`make_sharded_train_step`: ``params_rep`` is then DTensors on
    that inner mesh, placed by ``param_pspecs`` behind the replica axis
    (``fl_round.place(params_rep)``), and the batch is given whole to
    every rank of the pod.  Each rank takes the local steps as above,
    reduces its own local shards of its replicas through ``fedavg_agg``
    with lambda = 1 / ``n_replicas`` each, in ``agg_dtype``, and the
    pods' partial sums meet in one all-reduce over ``pod`` with lambda 1
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
    inner = None
    if mesh is not None:
        pods, inner = _pod_split(mesh)
        if n_replicas % pods:
            raise ValueError(f"{n_replicas} replicas do not split over "
                             f"{pods} pods")
        n_local = n_replicas // pods
    if inner is not None:
        axes = A.batch_spec_axes(inner, shape.global_batch // n_replicas)
        rep_specs = tree_map(lambda s: PartitionSpec(None, *s),
                             param_pspecs(cfg, abstract_params(cfg)))
        plain_step = local_step

        def local_step(params, batch):
            with on_mesh(inner, axes):
                params, metrics = plain_step(params,
                                             place_batch(batch, inner, axes))
            return params, replicated(metrics)

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
                x = x.to_local() if A.is_dtensor(x) else x
                x.copy_(a.to(x.dtype).expand_as(x))
        if mesh is None:
            metrics = {key: torch.stack([m[key] for m in per_replica]
                                        ).mean() for key in per_replica[0]}
        else:
            metrics = _pod_metrics(per_replica)
        return params_rep, metrics

    def _pod_aggregate(params_rep):
        """This rank's replicas (its local shards of them) at lambda 1 /
        n_replicas each through ``fedavg_agg`` (no normalization: the
        weights are global), then the all-reduce over ``pod``: the ranks
        it joins hold the same shard of every leaf."""
        local = tree_map(lambda x: x.to_local() if A.is_dtensor(x) else x,
                         params_rep)
        w = torch.full((n_local,), 1.0 / n_replicas, dtype=torch.float32,
                       device=tree_leaves(local)[0].device)
        return shard_weighted_aggregate(
            tree_map(lambda x: x.to(adt), local), w, ("pod",), mesh)

    def _pod_metrics(per_replica):
        keys = sorted(per_replica[0])
        sums = torch.stack([torch.stack([m[k].float() for m in per_replica]
                                        ).sum() for k in keys])
        dist.all_reduce(sums, group=mesh.get_group("pod"))
        return {k: v / n_replicas for k, v in zip(keys, sums)}

    if inner is not None:
        fl_round.place = lambda params_rep: distribute_params(
            params_rep, inner, rep_specs)
    return fl_round
