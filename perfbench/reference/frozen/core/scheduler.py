# Frozen copy of src/repro_torch/core/scheduler.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Per-round orchestration: ties constellation, offloading and handover
together (Section III overview; Remark 1 gateway role)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from . import latency as lat
from . import network as net
from .constellation import (AccessInterval, WalkerStar, access_intervals,
                            serving_sequence)
from .handover import SpaceSchedule, space_latency, space_schedule
from .network import SAGIN, Satellite
from .offloading import OffloadPlan, evaluate_cluster
from .strategies import resolve_strategy


@dataclasses.dataclass
class RoundRecord:
    round_index: int
    plan: OffloadPlan
    schedule: SpaceSchedule
    latency: float                 # analytic round latency (eq. 18)
    wall_clock_start: float        # cumulative time when round started
    ground_sizes: List[int]
    air_sizes: List[int]
    sat_size: int
    realized_latency: float = 0.0  # latency after stochastic events
    events: Optional[object] = None        # sim.dynamics.RoundEvents
    offline_devices: tuple = ()            # churned-out this round


class SAGINOrchestrator:
    """Simulates the full multi-round FL orchestration of the paper.

    Each round: (1) refresh the serving-satellite chain from the
    constellation at the current wall-clock; (2) sample this round's
    network events (outages, weather, jitter, churn) when a dynamics
    process is attached; (3) run the data-placement strategy hook;
    (4) apply the plan (moving integer sample counts with conservation
    repair); (5) advance the wall clock by the *realized* latency — the
    plan is made against nominal rates, then re-priced under the round's
    realized channel/ISL conditions, so dynamics hit the trajectory the
    way unforecast weather hits a real deployment.

    ``strategy`` is a registered name from ``core.strategies`` (the
    Section VI-A schemes) or any ``(orchestrator, round) -> OffloadPlan``
    callable.  All randomness (satellite CPU draws) flows from the
    explicit ``rng`` generator; pass one spawned per region for
    reproducible multi-region simulations.
    """

    def __init__(self, sagin: SAGIN,
                 constellation: Optional[WalkerStar] = None,
                 lat_deg: float = 40.0, lon_deg: float = -86.0,
                 sat_f_seed: int = 0, horizon: float = 48 * 3600.0,
                 strategy: str = "adaptive",
                 rng: Optional[np.random.Generator] = None,
                 dynamics: Optional[object] = None,
                 intervals: Optional[Sequence[AccessInterval]] = None,
                 min_elevation_deg: float = 15.0):
        self.sagin = sagin
        self.constellation = constellation
        self.strategy = strategy
        self._strategy_fn = resolve_strategy(strategy)
        self._static_plan: Optional[OffloadPlan] = None
        self._rng = rng if rng is not None else np.random.default_rng(
            sat_f_seed)
        self.dynamics = dynamics
        self.wall_clock = 0.0
        self.records: List[RoundRecord] = []
        if intervals is not None:
            self._intervals = list(intervals)
        elif constellation is not None:
            self._intervals = access_intervals(
                constellation, lat_deg, lon_deg, t_end=horizon,
                min_elevation_deg=min_elevation_deg)
        else:
            self._intervals = None
        # static satellite lists keep their nominal frequencies so that
        # per-round jitter never compounds across rounds
        self._base_sat_f = ([s.f for s in sagin.satellites]
                            if self._intervals is None else None)

    # -- satellite chain ----------------------------------------------------
    def _refresh_satellites(self):
        if self._intervals is None:
            if self._base_sat_f is not None:
                for sat, f in zip(self.sagin.satellites, self._base_sat_f):
                    sat.f = f
            return  # static satellite list supplied by the user
        chain = serving_sequence(self._intervals, self.wall_clock)
        sats = []
        for iv in chain:
            f = float(self._rng.uniform(*net.F_SAT_RANGE))
            sats.append(Satellite(index=iv.sat, f=f,
                                  coverage_end=max(0.0,
                                                   iv.end - self.wall_clock)))
        if not sats:
            sats = [Satellite(index=-1,
                              f=float(self._rng.uniform(*net.F_SAT_RANGE)),
                              coverage_end=np.inf)]
        self.sagin.satellites = sats

    # -- strategies ---------------------------------------------------------
    def _plan_round(self, r: int) -> OffloadPlan:
        return self._strategy_fn(self, r)

    # -- dynamics -----------------------------------------------------------
    def _sample_events(self, r: int):
        if self.dynamics is None:
            return None
        events = self.dynamics.sample_round(
            r, n_sats=len(self.sagin.satellites),
            n_clusters=len(self.sagin.clusters),
            n_devices=len(self.sagin.devices))
        # compute jitter is observable: the planner sees the jittered f
        for sat, scale in zip(self.sagin.satellites, events.sat_freq_scale):
            sat.f *= float(scale)
        return events

    def _strip_offline(self, plan: OffloadPlan, offline: Sequence[int]):
        """Offline devices neither send nor receive data this round.

        Dropping a churned device's ground->air feed can leave the air
        node promising the satellite more than it will actually hold, so
        the upward transfer is clamped to the realizable mass and the
        plan's satellite target is re-derived from the surviving moves.
        """
        off = set(offline)
        sagin = self.sagin
        for cp in plan.clusters:
            cp.d_ground_air = {k: d for k, d in cp.d_ground_air.items()
                               if k not in off}
            cp.d_air_ground = {k: d for k, d in cp.d_air_ground.items()
                               if k not in off}
            realizable = (sagin.air_nodes[cp.n].n_samples + cp.d_space_air
                          + sum(cp.d_ground_air.values())
                          - sum(cp.d_air_ground.values()))
            cp.d_air_space = min(cp.d_air_space, max(0.0, realizable))
        plan.new_sat_samples = sagin.n_sat_samples + sum(
            cp.d_air_space - cp.d_space_air for cp in plan.clusters)

    def _realized_latency(self, plan: OffloadPlan, events) -> float:
        """Re-price the committed plan under the round's realized
        channel/ISL conditions (the planner only saw nominal rates)."""
        if events.quiet:
            return plan.round_latency
        sagin = self.sagin
        saved = (sagin._g2a, sagin._a2s, sagin._s2a, sagin.z_isl)
        try:
            rs = events.rate_scale
            sagin._g2a = {k: v * rs for k, v in saved[0].items()}
            sagin._a2s = {k: v * rs for k, v in saved[1].items()}
            sagin._s2a = {k: v * rs for k, v in saved[2].items()}
            sagin.z_isl = saved[3] * events.isl_scale
            t_space = space_latency(plan.new_sat_samples, sagin)
            t_air = 0.0
            for cp in plan.clusters:
                t = (evaluate_cluster(sagin, cp,
                                      offline=events.offline_devices)
                     + lat.model_upload_time(sagin.model_bits,
                                             sagin.a2s_rate(cp.n))
                     + events.uplink_delays.get(cp.n, 0.0))
                t_air = max(t_air, t)
            return max(t_space, t_air)
        finally:
            sagin._g2a, sagin._a2s, sagin._s2a, sagin.z_isl = saved

    # -- application --------------------------------------------------------
    def _apply_plan(self, plan: OffloadPlan):
        sagin = self.sagin
        g, a, s = plan.new_sizes(sagin)
        # integer rounding with conservation repair
        total_before = sagin.total_samples
        g = [int(round(x)) for x in g]
        a = [int(round(x)) for x in a]
        s = int(round(s))
        drift = total_before - (sum(g) + sum(a) + s)
        s += drift
        if s < 0:
            a[0] += s
            s = 0
        for k, dev in enumerate(sagin.devices):
            dev.n_samples = max(dev.n_sensitive, g[k])
        for n, air in enumerate(sagin.air_nodes):
            air.n_samples = max(0, a[n])
        sagin.n_sat_samples = max(0, s)

    # -- main loop ----------------------------------------------------------
    def step(self, r: int) -> RoundRecord:
        self._refresh_satellites()
        events = self._sample_events(r)
        plan = self._plan_round(r)
        if events is not None and events.offline_devices:
            self._strip_offline(plan, events.offline_devices)
        schedule = space_schedule(plan.new_sat_samples, self.sagin)
        realized = (plan.round_latency if events is None
                    else self._realized_latency(plan, events))
        rec = RoundRecord(
            round_index=r, plan=plan, schedule=schedule,
            latency=plan.round_latency, wall_clock_start=self.wall_clock,
            ground_sizes=[d.n_samples for d in self.sagin.devices],
            air_sizes=[a.n_samples for a in self.sagin.air_nodes],
            sat_size=self.sagin.n_sat_samples,
            realized_latency=realized, events=events,
            offline_devices=(events.offline_devices if events else ()))
        self._apply_plan(plan)
        rec.ground_sizes = [d.n_samples for d in self.sagin.devices]
        rec.air_sizes = [a.n_samples for a in self.sagin.air_nodes]
        rec.sat_size = self.sagin.n_sat_samples
        self.wall_clock += realized
        self.records.append(rec)
        return rec

    def run(self, n_rounds: int) -> List[RoundRecord]:
        return [self.step(r) for r in range(n_rounds)]
