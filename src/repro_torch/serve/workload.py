"""Scenario-coupled inference request arrivals (the serving workload).

The serving half of the paper's story needs *traffic*: this module turns
a scenario's dynamics into per-region request arrival processes the
gateway can admit.  Each region runs a non-homogeneous Poisson process
whose instantaneous rate is the product of four factors:

* a **diurnal load curve** — ``1 + amplitude * sin(2*pi*(t/period +
  phase))`` with the phase derived from the region's longitude, so
  "local evening" peaks at different simulated instants per region;
* **burst episodes** — a 2-state Gilbert–Elliott chain per region
  (``burst_markov=(p_enter, p_exit)`` per slot, the exact idiom of
  :meth:`repro_torch.sim.dynamics.NetworkDynamics._ge_step`) multiplies the
  rate by ``burst_multiplier`` while in the burst state.  One uniform
  is drawn per slot regardless of state, so the draw count — hence the
  whole arrival trajectory — never depends on the realized episodes;
* **device-churn scaling** — the online fraction of the region's client
  population (sampled from the scenario's ``churn_prob``) scales the
  rate: offline devices issue no requests;
* the configured ``base_rate`` (requests/s per region at nominal load).

Randomness is fully threaded: every region's workload draws from its own
:class:`numpy.random.Generator` rooted at ``region_seed(seed, i)`` but
folded with a serve-plane stream constant, so the serving traffic is
seeded and replayable WITHOUT consuming a single draw from the training
streams (trajectory bit-identity with a gateway attached is test-locked).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Tuple

import numpy as np

#: Stream fold distinguishing serve-plane RNGs from the training streams
#: rooted at the same ``region_seed`` ("SERV" in ASCII).
SERVE_STREAM = 0x53455256


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-gateway wiring for one run (``FLConfig.serve`` /
    ``Scenario.serve``; ``FLConfig`` wins when both are set).

    ``base_rate`` is requests/s per region at nominal population and
    mid-curve load.  ``burst_markov=(p_enter, p_exit)`` arms the
    Gilbert–Elliott burst chain (per ``dt`` slot); ``None`` keeps
    arrivals burst-free.  ``router`` names a registered policy from
    :mod:`repro_torch.serve.router`.  ``batch_align``/``max_batch``
    control the gateway's geometric request batching (compile-once
    shapes); ``max_batch=1`` degenerates to per-request dispatch (the
    benchmark baseline).  ``link_refresh`` is how often (simulated
    seconds) the gateway re-samples the serving-plane link state from
    the scenario's :class:`~repro_torch.sim.dynamics.DynamicsConfig`.
    """
    base_rate: float = 2.0
    diurnal_amplitude: float = 0.5
    diurnal_period: float = 86400.0
    burst_markov: Optional[Tuple[float, float]] = None
    burst_multiplier: float = 6.0
    churn_coupling: bool = True
    dt: float = 1.0
    link_refresh: float = 30.0
    router: str = "min_rt"
    batch_align: int = 8
    max_batch: int = 64

    def __post_init__(self):
        if self.base_rate < 0:
            raise ValueError(f"base_rate must be >= 0, got {self.base_rate}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError(f"diurnal_amplitude must be in [0, 1), got "
                             f"{self.diurnal_amplitude}")
        if self.burst_markov is not None:
            p_enter, p_exit = self.burst_markov
            if not (0.0 <= p_enter <= 1.0 and 0.0 < p_exit <= 1.0):
                raise ValueError(
                    f"burst_markov=(p_enter={p_enter}, p_exit={p_exit}) "
                    f"needs p_enter in [0, 1] and p_exit in (0, 1]")
        if self.burst_multiplier < 1.0:
            raise ValueError(f"burst_multiplier must be >= 1, got "
                             f"{self.burst_multiplier}")
        if self.dt <= 0:
            raise ValueError(f"dt must be > 0, got {self.dt}")
        if self.max_batch < 1 or self.batch_align < 1:
            raise ValueError(f"max_batch/batch_align must be >= 1, got "
                             f"{self.max_batch}/{self.batch_align}")


def serve_rng(seed: int, region_index: int) -> np.random.Generator:
    """Serve-plane generator for one region: rooted at the region's
    canonical seed, folded with :data:`SERVE_STREAM` so it never aliases
    the training/dynamics streams of
    :func:`repro_torch.sim.engine.region_streams`.
    """
    from ..sim.engine import region_seed
    return np.random.default_rng((region_seed(seed, region_index),
                                  SERVE_STREAM))


@dataclasses.dataclass
class Request:
    """One inference request admitted by the gateway."""
    rid: int                    # unique per gateway, admission order
    region: int                 # originating region index
    t_arrival: float            # simulated arrival instant (s)
    sample: int                 # index into the origin region's eval batch
    # routing / completion (filled in by the gateway) -----------------------
    target: Tuple[str, int] = ("sat", -1)   # (kind, region) node key
    t_done: float = -1.0
    latency: float = -1.0       # end-to-end simulated seconds
    wait: float = 0.0           # queueing share of the latency (s)
    correct: Optional[bool] = None


class RegionWorkload:
    """Per-region arrival process over simulated time slots.

    ``step(t0)`` advances one ``cfg.dt`` slot starting at ``t0`` and
    returns the slot's arrivals as ``(offset, sample)`` pairs —
    offsets are uniform within the slot and sorted, sample indices
    address the region's eval set.  The burst chain advances EVERY slot
    with exactly one uniform (state-independent draw count), and the
    churn thinning draws one binomial per slot when armed.
    """

    def __init__(self, cfg: ServeConfig, region_index: int, seed: int,
                 n_eval: int, n_devices: int = 0, churn_prob: float = 0.0,
                 phase: float = 0.0):
        if n_eval < 1:
            raise ValueError(f"region {region_index}: empty eval set")
        self.cfg = cfg
        self.region_index = region_index
        self.rng = serve_rng(seed, region_index)
        self.n_eval = int(n_eval)
        self.n_devices = int(n_devices)
        self.churn_prob = float(churn_prob) if cfg.churn_coupling else 0.0
        self.phase = float(phase)
        self.bursting = False

    def rate_at(self, t: float) -> float:
        """Instantaneous request rate (requests/s) BEFORE churn thinning."""
        cfg = self.cfg
        diurnal = 1.0 + cfg.diurnal_amplitude * math.sin(
            2.0 * math.pi * (t / cfg.diurnal_period + self.phase))
        burst = cfg.burst_multiplier if self.bursting else 1.0
        return cfg.base_rate * diurnal * burst

    def step(self, t0: float) -> List[Tuple[float, int]]:
        cfg = self.cfg
        rng = self.rng
        if cfg.burst_markov is not None:
            p_enter, p_exit = cfg.burst_markov
            u = rng.random()
            # the Gilbert–Elliott transition of sim.dynamics._ge_step:
            # quiet slots enter a burst with p_enter, bursting slots
            # exit with p_exit — one uniform per slot either way
            self.bursting = (u >= p_exit) if self.bursting else (u < p_enter)
        online = 1.0
        if self.churn_prob > 0.0 and self.n_devices > 0:
            online = rng.binomial(self.n_devices,
                                  1.0 - self.churn_prob) / self.n_devices
        lam = self.rate_at(t0) * online * cfg.dt
        n = int(rng.poisson(lam)) if lam > 0 else 0
        if n == 0:
            return []
        offsets = np.sort(rng.random(n)) * cfg.dt
        samples = rng.integers(0, self.n_eval, size=n)
        return [(float(o), int(s)) for o, s in zip(offsets, samples)]

    def arrivals(self, t0: float, t1: float) -> Iterator[Tuple[float, int]]:
        """Every arrival in ``[t0, t1)`` as absolute ``(t, sample)`` pairs."""
        n_slots = int(math.ceil((t1 - t0) / self.cfg.dt))
        for k in range(n_slots):
            base = t0 + k * self.cfg.dt
            for off, sample in self.step(base):
                t = base + off
                if t < t1:
                    yield t, sample
