"""Stochastic SAGIN network dynamics: outages, weather, jitter, churn.

The seed's round model is purely analytic and deterministic; this module
adds the event processes that make a scenario *dynamic*:

* **ISL outages** — with probability ``isl_outage_prob`` per round the
  inter-satellite link degrades to ``isl_outage_scale`` of its nominal
  rate (rain fade / pointing loss on the optical/Ka link), stretching
  every handover in that round.
* **Uplink outages** — per cluster, the air->space uplink suffers a
  dead-air window of ``uplink_outage_delay`` seconds with probability
  ``uplink_outage_prob`` (blockage, beam re-acquisition).
* **Weather attenuation** — a lognormal multiplicative factor with
  sigma ``weather_std`` on all ground/air channel rates for the round.
* **Satellite compute jitter** — lognormal factor with sigma
  ``sat_freq_jitter_std`` on each serving satellite's CPU frequency
  (thermal throttling, shared payloads).  Unlike the other processes
  this one is *observable*: the orchestrator refreshes satellite state
  every round anyway, so the planner sees the jittered frequency.
* **Device churn** — each ground device is offline for the round with
  probability ``churn_prob``; offline devices neither move data nor
  train.

**Bursty (Markov) outages** — the i.i.d. per-round draws above cannot
model the *correlated* failure bursts real optical ISLs and Ka uplinks
exhibit (a pointing loss persists across rounds; rain cells last
minutes).  Setting ``isl_markov=(p_fail, p_recover)`` (and/or
``uplink_markov``) replaces the corresponding i.i.d. draw with a
2-state Gilbert–Elliott chain per link: a *good* link fails with
``p_fail`` per round, a *bad* link recovers with ``p_recover``, giving
a stationary outage fraction ``p_fail / (p_fail + p_recover)`` and
mean burst length ``1 / p_recover`` rounds.  Exactly ONE uniform is
drawn per link per round regardless of state, so trajectories stay
deterministic under identical seeds and the draw count never depends
on the realized states.  The chain state is mutable run state — it is
part of :meth:`NetworkDynamics.state_dict` so engine checkpoints
resume mid-burst bit-identically.

Every process draws from one explicit :class:`numpy.random.Generator`
threaded through the constructor — identical seeds give identical
multi-round event trajectories, and the engine derives independent
per-region streams with :meth:`NetworkDynamics.spawn`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


def _validate_markov(name: str, pair) -> None:
    if pair is None:
        return
    if len(pair) != 2:
        raise ValueError(f"{name} must be a (p_fail, p_recover) pair, "
                         f"got {pair!r}")
    p_fail, p_recover = pair
    if not (0.0 <= p_fail <= 1.0 and 0.0 < p_recover <= 1.0):
        raise ValueError(f"{name}=(p_fail={p_fail}, p_recover={p_recover}) "
                         f"needs p_fail in [0, 1] and p_recover in (0, 1]")


@dataclasses.dataclass(frozen=True)
class DynamicsConfig:
    """Per-round event-process rates; all zero means static (seed) behavior."""
    isl_outage_prob: float = 0.0
    isl_outage_scale: float = 0.25      # z_isl multiplier while degraded
    uplink_outage_prob: float = 0.0     # per cluster, per round
    uplink_outage_delay: float = 20.0   # seconds of dead air per outage
    weather_std: float = 0.0            # lognormal sigma on channel rates
    sat_freq_jitter_std: float = 0.0    # lognormal sigma on satellite f
    churn_prob: float = 0.0             # per ground device, per round
    # Gilbert–Elliott bursty outages: (p_fail, p_recover) per round.
    # When set, the chain REPLACES the corresponding i.i.d. draw above
    # (the iid prob is ignored for that link class).
    isl_markov: Optional[Tuple[float, float]] = None
    uplink_markov: Optional[Tuple[float, float]] = None

    def __post_init__(self):
        _validate_markov("isl_markov", self.isl_markov)
        _validate_markov("uplink_markov", self.uplink_markov)

    def any_active(self) -> bool:
        return (self.isl_outage_prob > 0 or self.uplink_outage_prob > 0
                or self.weather_std > 0 or self.sat_freq_jitter_std > 0
                or self.churn_prob > 0 or self.isl_markov is not None
                or self.uplink_markov is not None)


@dataclasses.dataclass
class RoundEvents:
    """Realized events for one global round."""
    round_index: int
    sat_freq_scale: np.ndarray          # (n_sats,) observable at planning
    isl_scale: float = 1.0              # z_isl multiplier (<1 during outage)
    rate_scale: float = 1.0             # weather multiplier on channel rates
    uplink_delays: Dict[int, float] = dataclasses.field(default_factory=dict)
    offline_devices: Tuple[int, ...] = ()

    @property
    def quiet(self) -> bool:
        """True when no *unobservable* perturbation realized this round.

        Satellite compute jitter is deliberately excluded: it is applied
        to the satellites before planning, so the plan already prices it
        and re-pricing the round would return the analytic latency.
        """
        return (self.isl_scale == 1.0 and self.rate_scale == 1.0
                and not self.uplink_delays and not self.offline_devices)


class NetworkDynamics:
    """Samples :class:`RoundEvents` from an explicit, threaded RNG.

    ``tracer`` is the run's :class:`repro_torch.obs.Tracer` (attached by
    ``RegionTrainer``/``SAGINEngine``; the shared null tracer by
    default): every realized *unobservable* perturbation is emitted as
    an ``outage`` event against the tracer's current region/round
    context.  Emission happens AFTER all draws — tracing never touches
    the RNG stream, so trajectories are identical with obs on or off.
    """

    def __init__(self, config: DynamicsConfig,
                 rng: Optional[np.random.Generator] = None, seed: int = 0):
        from ..obs import NULL_TRACER
        self.config = config
        self.rng = rng if rng is not None else np.random.default_rng(seed)
        self.tracer = NULL_TRACER
        # Gilbert–Elliott chain states (mutable run state; checkpointed)
        self._isl_bad = False
        self._uplink_bad: Optional[np.ndarray] = None  # (n_clusters,) bool

    def spawn(self) -> "NetworkDynamics":
        """Independent child stream (one per region in the engine)."""
        child = NetworkDynamics(self.config, rng=self.rng.spawn(1)[0])
        child.tracer = self.tracer
        return child

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable run state: RNG stream + burst-chain states."""
        return {
            "rng": self.rng.bit_generator.state,
            "isl_bad": bool(self._isl_bad),
            "uplink_bad": (None if self._uplink_bad is None
                           else [bool(b) for b in self._uplink_bad]),
        }

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._isl_bad = bool(state["isl_bad"])
        ub = state.get("uplink_bad")
        self._uplink_bad = (None if ub is None
                            else np.asarray(ub, dtype=bool))

    # -- burst chains --------------------------------------------------------
    @staticmethod
    def _ge_step(bad, u, p_fail: float, p_recover: float):
        """One Gilbert–Elliott transition from ONE uniform per link.

        Good links fail when ``u < p_fail``; bad links recover when
        ``u < p_recover``.  Works elementwise on arrays.
        """
        return np.where(bad, u >= p_recover, u < p_fail)

    def sample_round(self, r: int, n_sats: int, n_clusters: int,
                     n_devices: int) -> RoundEvents:
        cfg = self.config
        rng = self.rng
        ev = RoundEvents(round_index=r, sat_freq_scale=np.ones(n_sats))
        if cfg.sat_freq_jitter_std > 0:
            ev.sat_freq_scale = rng.lognormal(
                mean=-0.5 * cfg.sat_freq_jitter_std ** 2,
                sigma=cfg.sat_freq_jitter_std, size=n_sats)
        if cfg.isl_markov is not None:
            # one uniform per round regardless of chain state: the draw
            # count (hence every downstream draw) is state-independent
            self._isl_bad = bool(self._ge_step(self._isl_bad, rng.random(),
                                               *cfg.isl_markov))
            if self._isl_bad:
                ev.isl_scale = cfg.isl_outage_scale
        elif cfg.isl_outage_prob > 0 and rng.random() < cfg.isl_outage_prob:
            ev.isl_scale = cfg.isl_outage_scale
        if cfg.weather_std > 0:
            ev.rate_scale = float(rng.lognormal(
                mean=-0.5 * cfg.weather_std ** 2, sigma=cfg.weather_std))
        if cfg.uplink_markov is not None:
            if self._uplink_bad is None or len(self._uplink_bad) != n_clusters:
                self._uplink_bad = np.zeros(n_clusters, dtype=bool)
            self._uplink_bad = self._ge_step(
                self._uplink_bad, rng.random(n_clusters), *cfg.uplink_markov)
            ev.uplink_delays = {int(n): cfg.uplink_outage_delay
                                for n in np.flatnonzero(self._uplink_bad)}
        elif cfg.uplink_outage_prob > 0:
            hit = rng.random(n_clusters) < cfg.uplink_outage_prob
            ev.uplink_delays = {int(n): cfg.uplink_outage_delay
                                for n in np.flatnonzero(hit)}
        if cfg.churn_prob > 0:
            off = rng.random(n_devices) < cfg.churn_prob
            ev.offline_devices = tuple(int(k) for k in np.flatnonzero(off))
        tr = self.tracer
        if tr.enabled:
            m = tr.metrics
            if ev.isl_scale != 1.0:
                tr.event("outage", "isl_fade", event="isl",
                         scale=ev.isl_scale,
                         bursty=cfg.isl_markov is not None)
                m.counter("outage.isl").inc()
            for n, d in sorted(ev.uplink_delays.items()):
                tr.event("outage", f"uplink_c{n}", event="uplink",
                         cluster=n, delay=d,
                         bursty=cfg.uplink_markov is not None)
                m.counter("outage.uplink").inc()
            if ev.offline_devices:
                tr.event("outage", "device_churn", event="churn",
                         devices=list(ev.offline_devices))
                m.counter("outage.churned_devices").inc(
                    len(ev.offline_devices))
        return ev
