# Frozen copy of src/repro_torch/core/convergence.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Theorem 1 convergence-bound evaluator (Section V).

Evaluates the right-hand side of eq. (38) for a given run configuration so
experiments can compare the analytic bound against empirical gradient norms.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class ConvergenceConfig:
    smoothness: float            # L
    sigma_g: float               # mini-batch gradient noise std bound
    c_r: Sequence[float]         # per-round dissimilarity slope (Assumption 3)
    delta_r: Sequence[float]     # per-round dissimilarity offset
    h_local: int                 # H local iterations
    f0_minus_fstar: float        # F(w^0) - F*


def max_learning_rate(cfg: ConvergenceConfig, r: int) -> float:
    """eq. (37): eta^{(r)} <= 1 / (2 sqrt(1+c_r) H L)."""
    return 1.0 / (2.0 * np.sqrt(1.0 + cfg.c_r[r]) * cfg.h_local
                  * cfg.smoothness)


def decaying_lr(eta0: float, r: int) -> float:
    """eta^{(r)} = eta^{(0)} / (r+1) (Section V discussion)."""
    return eta0 / (r + 1)


def constant_lr(h: int, n_rounds: int) -> float:
    """eta = 1/sqrt(H R)."""
    return 1.0 / np.sqrt(h * n_rounds)


def theorem1_bound(cfg: ConvergenceConfig, etas: Sequence[float],
                   lambdas_sq: Sequence[float]) -> float:
    """RHS of eq. (38).

    ``lambdas_sq[r]`` = sum_i (lambda_i^{(r)})^2 over all nodes i in round r
    (time-varying because offloading changes the data portions).
    Returns the bound on (1/Gamma_R) sum_r eta_r E||grad F(w_r)||^2.
    """
    etas = np.asarray(etas, dtype=np.float64)
    lam2 = np.asarray(lambdas_sq, dtype=np.float64)
    c = np.asarray(cfg.c_r, dtype=np.float64)[: len(etas)]
    d2 = np.asarray(cfg.delta_r, dtype=np.float64)[: len(etas)] ** 2
    gamma = float(np.sum(etas))
    h, big_l, sg2 = cfg.h_local, cfg.smoothness, cfg.sigma_g ** 2
    term1 = 4.0 * cfg.f0_minus_fstar / (h * gamma)
    term2 = 4.0 * big_l / gamma * float(np.sum(etas ** 2 * lam2)) * sg2
    term3 = 2.0 * h ** 2 * big_l ** 2 * sg2 / gamma * float(np.sum(etas ** 3))
    term4 = 4.0 * h ** 2 * big_l ** 2 / gamma * float(np.sum(etas ** 3 * d2))
    return term1 + term2 + term3 + term4


def bound_decays_to_zero(cfg: ConvergenceConfig, n_rounds: int,
                         lambdas_sq: float = 1.0) -> np.ndarray:
    """Bound as a function of R with eta = 1/sqrt(HR); should -> 0."""
    out = []
    for r_tot in range(1, n_rounds + 1):
        eta = constant_lr(cfg.h_local, r_tot)
        etas = [eta] * r_tot
        lam2 = [lambdas_sq] * r_tot
        c = ConvergenceConfig(cfg.smoothness, cfg.sigma_g,
                              [cfg.c_r[0]] * r_tot, [cfg.delta_r[0]] * r_tot,
                              cfg.h_local, cfg.f0_minus_fstar)
        out.append(theorem1_bound(c, etas, lam2))
    return np.asarray(out)
