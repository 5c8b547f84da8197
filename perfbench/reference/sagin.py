"""The reference of the SAGIN FL round: the control plane replayed with
the frozen NumPy copies, and the rounds' training in plain VGG-11.

:class:`Replay` works out again, from the seed and the FL settings,
everything a region's job derives: the synthetic dataset, the partition
over the ground devices, the index pools, the network model, the
orchestrator's plan of every round, its moves of samples between the
layers, and every node's (H, B) batches, drawing from the same NumPy
streams in the same order as the job does (the dataset, the partition
and the batches from the region's stream; the held-out evaluation draw
between them).  ``_apply_plan_to_pools``, ``_sync_sizes`` and
``_node_pools`` are frozen copies of src/repro_torch/fl/rounds.py's at
commit ed1d7aa.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import vgg11 as V
from .frozen.core import SAGINOrchestrator, build_default_sagin
from .frozen.data import (FederatedPools, batch_for_local_steps,
                          make_dataset, partition)
from .frozen.data.pipeline import batch_width_for_pool


class Replay:
    """One region's control plane at ``seed``, without any model."""

    def __init__(self, fl: dict, seed: int, n_params: int):
        self.fl = fl
        self.rng = np.random.default_rng(seed)
        self.ds = make_dataset(fl["dataset"], seed=seed,
                               train_fraction=fl["train_fraction"],
                               sample_seed=seed)
        parts = partition(self.ds, n_devices=fl["n_devices"], iid=fl["iid"],
                          alpha=fl["alpha"], seed=seed)
        self.pools = FederatedPools.from_partitions(parts, fl["n_air"])
        self.sagin = build_default_sagin(
            n_devices=fl["n_devices"], n_air=fl["n_air"], alpha=fl["alpha"],
            q_bits=self.ds.sample_bits, model_bits=float(n_params * 32),
            rayleigh=fl["rayleigh"], seed=seed)
        for k, p in enumerate(parts):
            self.sagin.devices[k].n_samples = p.n_samples
            self.sagin.devices[k].n_sensitive = p.n_sensitive
        self.orch = SAGINOrchestrator(self.sagin, constellation=None,
                                      sat_f_seed=seed,
                                      strategy=fl["strategy"])
        # the job's held-out evaluation draw comes from the same stream
        self.rng.choice(len(self.ds.x_test),
                        size=min(fl["eval_size"], len(self.ds.x_test)),
                        replace=False)

    def plan(self, r: int) -> List[np.ndarray]:
        """Round ``r``'s plan applied: the index pool of every node that
        trains, in the job's order."""
        rec = self.orch.step(r)
        _apply_plan_to_pools(rec.plan, self.pools)
        _sync_sizes(self.pools, self.sagin)
        return _node_pools(self.fl, self.pools)

    def clients(self, pools: Sequence[np.ndarray], device
                ) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
        """Every node's (H, B) batches on ``device`` and its pool size."""
        out = []
        for idx in pools:
            xs, ys = batch_for_local_steps(
                self.ds.x_train, self.ds.y_train, idx, self.fl["h_local"],
                self.rng, max_batch=self.fl["batch_cap"])
            out.append((torch.from_numpy(xs).to(device),
                        torch.from_numpy(ys).to(device, torch.int64),
                        len(idx)))
        return out


def real_samples(pools: Sequence[np.ndarray], h_local: int,
                 batch_cap: int) -> int:
    """Samples a round trains: H x B over the nodes, B by the pipeline's
    sizing rule."""
    return sum(h_local * batch_width_for_pool(len(p), h_local, batch_cap)
               for p in pools if len(p))


def run(params, fl: dict, seed: int, n_rounds: int, device):
    """The first ``n_rounds`` rounds from ``params``: (the mean client
    loss of each round, the params after each round)."""
    replay = Replay(fl, seed, sum(p.numel() for p in V.leaves(params)))
    losses, after = [], []
    for r in range(n_rounds):
        clients = replay.clients(replay.plan(r), device)
        params, loss = V.round_update(params, clients, fl["lr"])
        losses.append(loss)
        after.append(params)
        del clients
    return losses, after


def _apply_plan_to_pools(plan, pools: FederatedPools):
    """Mirror the optimizer's (fractional) plan as integer index moves."""
    for cp in plan.clusters:
        n = cp.n
        if cp.d_space_air > 0:
            pools.move_sat_to_air(n, int(round(cp.d_space_air)))
        for k, d in sorted(cp.d_air_ground.items()):
            pools.move_air_to_ground(n, k, int(round(d)))
        for k, d in sorted(cp.d_ground_air.items()):
            pools.move_ground_to_air(k, n, int(round(d)))
        if cp.d_air_space > 0:
            pools.move_air_to_sat(n, int(round(cp.d_air_space)))


def _sync_sizes(pools: FederatedPools, sagin):
    for k, dev in enumerate(sagin.devices):
        dev.n_samples = len(pools.ground_all(k))
        dev.n_sensitive = len(pools.ground_sensitive[k])
    for n, air in enumerate(sagin.air_nodes):
        air.n_samples = len(pools.air[n])
    sagin.n_sat_samples = len(pools.sat)


def _node_pools(fl: dict, pools: FederatedPools) -> List[np.ndarray]:
    out = []
    for k in range(fl["n_devices"]):
        idx = pools.ground_all(k)
        if len(idx):
            out.append(idx)
    for n in range(fl["n_air"]):
        if len(pools.air[n]):
            out.append(pools.air[n])
    if len(pools.sat):
        out.append(pools.sat)
    return out
