# Frozen copy of src/repro_torch/data/partition.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Federated data partitioning (Section VI-A).

IID: uniform random allocation to the K ground devices.
Non-IID: sort by class, split into 200 shards, assign 4 shards per device
(the paper's protocol; generalizes to other K via shards = 4*K).
Sensitive/non-sensitive split: a fraction alpha of each device's samples is
non-sensitive (offloadable), the rest must stay on-device (Section II).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .synthetic import Dataset


@dataclasses.dataclass
class DevicePartition:
    device: int
    indices: np.ndarray            # into x_train
    sensitive_mask: np.ndarray     # True -> must stay on the device

    @property
    def n_samples(self) -> int:
        return len(self.indices)

    @property
    def n_sensitive(self) -> int:
        return int(self.sensitive_mask.sum())

    @property
    def offloadable_indices(self) -> np.ndarray:
        return self.indices[~self.sensitive_mask]

    @property
    def sensitive_indices(self) -> np.ndarray:
        return self.indices[self.sensitive_mask]


def partition(ds: Dataset, n_devices: int = 50, iid: bool = True,
              alpha: float = 0.8, shards_per_device: int = 4,
              seed: int = 0) -> List[DevicePartition]:
    rng = np.random.default_rng(seed)
    n = len(ds.x_train)
    if iid:
        perm = rng.permutation(n)
        splits = np.array_split(perm, n_devices)
    else:
        order = np.argsort(ds.y_train, kind="stable")
        n_shards = shards_per_device * n_devices
        shards = np.array_split(order, n_shards)
        shard_ids = rng.permutation(n_shards)
        splits = []
        for d in range(n_devices):
            ids = shard_ids[d * shards_per_device:(d + 1) * shards_per_device]
            splits.append(np.concatenate([shards[i] for i in ids]))
    out = []
    for d, idx in enumerate(splits):
        idx = np.asarray(idx)
        n_sens = int(round((1.0 - alpha) * len(idx)))
        mask = np.zeros(len(idx), dtype=bool)
        if n_sens > 0:
            mask[rng.choice(len(idx), size=n_sens, replace=False)] = True
        out.append(DevicePartition(device=d, indices=idx,
                                   sensitive_mask=mask))
    return out


@dataclasses.dataclass
class FederatedPools:
    """Mutable sample pools per node, updated by offloading each round.

    ``ground[k]``, ``air[n]``, ``sat`` are arrays of indices into x_train.
    Only non-sensitive indices ever move (the optimizer's plans are given in
    sample counts; we move the corresponding index sets).
    """
    ground: List[np.ndarray]
    ground_sensitive: List[np.ndarray]
    air: List[np.ndarray]
    sat: np.ndarray

    @classmethod
    def from_partitions(cls, parts: List[DevicePartition],
                        n_air: int) -> "FederatedPools":
        return cls(
            ground=[p.offloadable_indices.copy() for p in parts],
            ground_sensitive=[p.sensitive_indices.copy() for p in parts],
            air=[np.empty(0, dtype=np.int64) for _ in range(n_air)],
            sat=np.empty(0, dtype=np.int64),
        )

    def ground_all(self, k: int) -> np.ndarray:
        return np.concatenate([self.ground_sensitive[k], self.ground[k]])

    def total(self) -> int:
        return (sum(len(g) for g in self.ground)
                + sum(len(g) for g in self.ground_sensitive)
                + sum(len(a) for a in self.air) + len(self.sat))

    # -- moves (all amounts in #samples; clipped to availability) ------------
    def move_ground_to_air(self, k: int, n: int, amount: int) -> int:
        amount = int(min(amount, len(self.ground[k])))
        if amount <= 0:
            return 0
        moved, self.ground[k] = (self.ground[k][:amount],
                                 self.ground[k][amount:])
        self.air[n] = np.concatenate([self.air[n], moved])
        return amount

    def move_air_to_ground(self, n: int, k: int, amount: int) -> int:
        amount = int(min(amount, len(self.air[n])))
        if amount <= 0:
            return 0
        moved, self.air[n] = self.air[n][:amount], self.air[n][amount:]
        self.ground[k] = np.concatenate([self.ground[k], moved])
        return amount

    def move_air_to_sat(self, n: int, amount: int) -> int:
        amount = int(min(amount, len(self.air[n])))
        if amount <= 0:
            return 0
        moved, self.air[n] = self.air[n][:amount], self.air[n][amount:]
        self.sat = np.concatenate([self.sat, moved])
        return amount

    def move_sat_to_air(self, n: int, amount: int) -> int:
        amount = int(min(amount, len(self.sat)))
        if amount <= 0:
            return 0
        moved, self.sat = self.sat[:amount], self.sat[amount:]
        self.air[n] = np.concatenate([self.air[n], moved])
        return amount
