# Frozen copy of src/repro_torch/data/synthetic.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Synthetic stand-ins for the paper's FL benchmark datasets.

MNIST / FMNIST / CIFAR-10 are not downloadable in this container, so we
generate class-conditioned Gaussian-mixture image datasets with identical
shapes and cardinalities. Each class c has a random but fixed template
prototype; samples are prototype + noise, making the task learnable by the
same CNNs the paper uses, with a controllable difficulty (noise scale).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SPECS = {
    # name: (image shape, n_classes, n_train, n_test)
    "mnist": ((28, 28, 1), 10, 60000, 10000),
    "fmnist": ((28, 28, 1), 10, 60000, 10000),
    "cifar10": ((32, 32, 3), 10, 50000, 10000),
}


@dataclasses.dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1

    @property
    def sample_bits(self) -> float:
        """q: bits per sample (uint8 image + label byte), for the latency
        model."""
        return float(np.prod(self.x_train.shape[1:]) * 8 + 8)


def make_dataset(name: str, noise: float = 0.9, seed: int = 0,
                 train_fraction: float = 1.0,
                 sample_seed: int | None = None) -> Dataset:
    """Generate a synthetic dataset shaped like ``name``.

    ``train_fraction`` can shrink the dataset for fast tests.

    ``seed`` fixes the TASK (the class prototype templates);
    ``sample_seed`` (default: ``seed``) fixes the train/test sample
    draw around those prototypes.  Multi-region FL uses this split to
    give every region a different sample of the SAME task — models
    trained in different regions then solve one problem and can be
    merged into a global model.
    """
    shape, n_classes, n_train, n_test = SPECS[name]
    n_train = int(n_train * train_fraction)
    n_test = max(256, int(n_test * train_fraction))
    rng = np.random.default_rng(seed)
    protos = rng.normal(0.0, 1.0, size=(n_classes,) + shape).astype(np.float32)
    # smooth the prototypes a little so convolutions have structure to find
    for _ in range(2):
        protos = 0.5 * protos + 0.25 * (np.roll(protos, 1, axis=1)
                                        + np.roll(protos, -1, axis=1))

    def gen(n: int, seed2: int) -> Tuple[np.ndarray, np.ndarray]:
        r = np.random.default_rng(seed2)
        y = r.integers(0, n_classes, size=n).astype(np.int32)
        x = protos[y] + noise * r.normal(0.0, 1.0,
                                         size=(n,) + shape).astype(np.float32)
        return x.astype(np.float32), y

    s = seed if sample_seed is None else sample_seed
    x_tr, y_tr = gen(n_train, s + 1)
    x_te, y_te = gen(n_test, s + 2)
    return Dataset(name=name, x_train=x_tr, y_train=y_tr,
                   x_test=x_te, y_test=y_te)
