"""Train and prefill step factories of the transformer stack, on one
device.

The counterparts of the reference's ``launch/train.py`` without the mesh
and the shardings, with their names kept: ``abstract_params``,
``make_sharded_train_step`` (plain SGD; ``donate`` updates the params in
place), ``make_prefill_step``, and ``make_fl_train_step``, the paper's
hierarchical FL on transformers: every replica takes ``h_local`` local
SGD steps, then the eq.-(13) mean over the replicas runs through
``fedavg_agg``, one launch a round.  ``make_replica_agg_step`` waits for
the multi-device slice.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import InputShape
from ..device import resolve_device
from ..fl.aggregation import fedavg_stacked
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


def make_fl_train_step(cfg: ModelConfig, n_replicas: int,
                       shape: InputShape, lr: float = 1e-3,
                       h_local: int = 1, agg_dtype: str = "float32",
                       device="cuda"):
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

    def fl_round(params_rep, batch):
        _check_batch(batch, shape, (n_replicas,
                                    shape.global_batch // n_replicas))
        for leaf in tree_leaves(params_rep):
            if leaf.ndim < 1 or leaf.shape[0] != n_replicas:
                raise ValueError(f"every leaf needs a leading replica axis "
                                 f"of {n_replicas}, got shape "
                                 f"{tuple(leaf.shape)}")
        per_replica = []
        for r in range(n_replicas):
            replica = tree_map(lambda x: x[r], params_rep)
            local = {key: batch[key][r] for key in ("inputs", "labels")}
            for _ in range(h_local):
                replica, metrics = local_step(replica, local)
            per_replica.append(metrics)
        agg = fedavg_stacked(tree_map(lambda x: x.to(adt), params_rep),
                             weights)
        with torch.no_grad():
            for x, a in zip(tree_leaves(params_rep), tree_leaves(agg)):
                x.copy_(a.to(x.dtype).expand_as(x))
        metrics = {key: torch.stack([m[key] for m in per_replica]).mean()
                   for key in per_replica[0]}
        return params_rep, metrics

    return fl_round
