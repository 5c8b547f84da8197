"""Event-stepped multi-region SAGIN simulator and hierarchical FL driver.

Drives one :class:`~repro_torch.core.scheduler.SAGINOrchestrator` (or,
in FL mode, one :class:`~repro_torch.fl.rounds.RegionTrainer`) per
region over a *shared* constellation: coverage windows for every region
come from a single batched propagation pass
(:func:`repro_torch.sim.propagation.access_intervals_multi`, in NumPy or
on the card with ``backend="torch"``), and regions
advance through an event queue ordered by their wall clocks — the
region whose next round starts earliest steps first, exactly as a
gateway scheduler multiplexing one constellation across independent FL
jobs would interleave them.

**FL mode** (pass ``fl=FLConfig(...)``) replaces the bare orchestrators
with full per-region trainers, so the engine event-steps *actual
federated training*.  Cross-region merging is delegated to a pluggable
federation policy (:mod:`repro_torch.fl.federation`), resolved from
``FLConfig.federation`` or ``Scenario.federation`` (the deprecated
``Scenario.merge_*`` fields map to the ``synchronous`` policy): at each
merge boundary the engine EMITS a
:class:`~repro_torch.fl.federation.FederationState` (per-region
clock/model age, data mass, live ISL state from ``sim.dynamics``) and
executes whatever :class:`~repro_torch.fl.federation.MergePlan` the
policy returns — who participates with what staleness-discounted
weight, who receives the merged model, and what each recipient's ISL
toll is; the merge itself is one ``fedavg_agg`` launch on the card.  Barrier
policies (``synchronous``, ``partial``, ``elected_hub``) park arriving
regions until all have arrived; asynchronous policies (``soft_async``)
plan at each region's own boundary with no parking.  The engine knows
no merge semantics beyond that.

Randomness is fully threaded and *region-addressable*: region ``i``'s
orchestrator/dynamics streams are rooted at
``region_seed(seed, i) = seed + 1000 * i`` (see :func:`region_streams`),
the exact derivation :func:`repro_torch.fl.rounds.run_fl` applies for
``FLConfig(scenario=..., region_index=i)`` — a single-region FL job and
engine region ``i`` draw identical outage/churn/satellite-CPU streams
at equal seeds, and identical seeds give identical multi-region
trajectories regardless of interleaving.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

import numpy as np

from ..core.network import build_default_sagin
from ..core.scheduler import RoundRecord, SAGINOrchestrator
from .dynamics import DynamicsConfig, NetworkDynamics
from .propagation import Region

if TYPE_CHECKING:  # pragma: no cover - circular-import guard
    from ..fl.rounds import FLConfig, FLResult, RegionTrainer
    from ..scenarios.registry import Scenario


def region_seed(seed: int, region_index: int) -> int:
    """Root seed of region ``region_index``'s RNG streams.

    The fold is by construction independent of how many regions a
    scenario declares, so a single-region ``run_fl`` job can reproduce
    any engine region's draws without replaying the regions before it.
    """
    return seed + 1000 * region_index


def region_streams(seed: int, region_index: int,
                   dynamics_cfg: Optional[DynamicsConfig] = None
                   ) -> Tuple[np.random.Generator,
                              Optional[NetworkDynamics]]:
    """Canonical per-region ``(orchestrator_rng, dynamics)`` derivation.

    This is the ONE place the engine and :func:`repro_torch.fl.rounds.run_fl`
    agree on how region ``i``'s streams descend from a root seed: the
    orchestrator draws (satellite CPU frequencies) come from the root
    stream of ``region_seed(seed, i)`` and the dynamics events
    (outages/weather/churn) from its first spawned child — the same
    parent/child split the seed orchestrator used for a single region.
    """
    rseed = region_seed(seed, region_index)
    rng = np.random.default_rng(rseed)
    dynamics = None
    if dynamics_cfg is not None:
        dynamics = NetworkDynamics(
            dynamics_cfg, rng=np.random.default_rng(rseed).spawn(1)[0])
    return rng, dynamics


@dataclasses.dataclass
class RegionTrace:
    """Per-region outcome of an engine run."""
    region: Region
    records: List[RoundRecord] = dataclasses.field(default_factory=list)

    @property
    def wall_clock(self) -> float:
        return (self.records[-1].wall_clock_start
                + self.records[-1].realized_latency) if self.records else 0.0

    @property
    def latencies(self) -> List[float]:
        return [r.latency for r in self.records]

    @property
    def realized_latencies(self) -> List[float]:
        return [r.realized_latency for r in self.records]


@dataclasses.dataclass(frozen=True)
class MergeEvent:
    """One policy-planned merge across regions over the ISLs.

    The per-region tuples span ALL regions: a region that sat the merge
    out carries weight/staleness/cost 0 and accuracy NaN (accuracies are
    evaluated on recipients only).  ``participants``/``recipients``/
    ``hub`` record the realized :class:`~repro_torch.fl.federation.MergePlan`.
    """
    barrier_round: int            # regions had completed this many rounds
    time: float                   # merge wall-clock instant
    staleness: Tuple[float, ...]  # per-region model age at merge (s)
    weights: Tuple[float, ...]    # realized merge weights (sum to 1)
    isl_costs: Tuple[float, ...]  # per-region ISL price (s)
    accuracies: Tuple[float, ...]  # merged model on recipients' eval sets
    policy: str = "synchronous"   # federation policy that planned it
    hub: int = 0                  # aggregating region (its satellite)
    participants: Tuple[int, ...] = ()
    recipients: Tuple[int, ...] = ()


class SAGINEngine:
    """Multi-region simulator over one shared constellation.

    Without ``fl`` the engine steps bare orchestrators (network-only
    simulation).  With ``fl=FLConfig(...)`` it builds one
    :class:`~repro_torch.fl.rounds.RegionTrainer` per region (``fl.seed``
    governs all streams; the ``seed``/``n_devices``/``n_air`` arguments
    are ignored in favor of the FLConfig) and :meth:`run` performs
    event-stepped federated training with optional global merges.

    ``backend="torch"`` propagates on the card (on ``fl.device`` in FL
    mode); FL mode trains on ``fl.device``.  ``params`` (FL mode: one
    model in the port's layout, e.g. from
    :func:`repro_torch.convert.params_from_jax`) replaces the seeded
    initial model of every region.
    """

    def __init__(self, scenario: "Scenario | str", seed: int = 0,
                 n_devices: Optional[int] = None,
                 n_air: Optional[int] = None,
                 backend: str = "numpy",
                 fl: Optional["FLConfig"] = None, *, params=None):
        if isinstance(scenario, str):
            from ..scenarios.registry import get_scenario
            scenario = get_scenario(scenario)
        self.scenario = scenario
        self.constellation = scenario.build_constellation()
        self.intervals = scenario.build_intervals(
            backend=backend, device=fl.device if fl is not None else "cuda")
        self.fl_config = fl
        # ONE tracer for the whole run, shared by every region trainer
        # (FLConfig.obs wins over Scenario.obs); repro_torch.obs.NULL_TRACER
        # when neither is set — every hook below is then a single branch
        from ..obs import resolve_obs
        self.tracer = resolve_obs(
            fl.obs if fl is not None and fl.obs is not None
            else scenario.obs)
        self.trainers: List["RegionTrainer"] = []
        self.merges: List[MergeEvent] = []
        self.global_params = None
        self.federation = None
        self.fault_injector = None
        self.step_order: List[Tuple[int, int]] = []  # (region, round) pops
        self.traces: List[RegionTrace] = [RegionTrace(region=r)
                                          for r in scenario.regions]
        self.orchestrators: List[SAGINOrchestrator] = []
        if fl is not None:
            from ..fl.federation import resolve_federation
            from ..fl.rounds import RegionTrainer
            self.federation = resolve_federation(fl.federation, scenario)
            for i, region in enumerate(scenario.regions):
                cfg_i = dataclasses.replace(fl, scenario=scenario.name,
                                            region_index=i)
                self.trainers.append(RegionTrainer(
                    cfg_i, scenario=scenario,
                    intervals=self.intervals[region.name],
                    tracer=self.tracer, params=params))
            if scenario.faults is not None:
                # ONE injector shared by the merge path and every
                # trainer: counts aggregate run-wide
                from ..resilience import FaultInjector
                self.fault_injector = FaultInjector(scenario.faults,
                                                    tracer=self.tracer)
                for t in self.trainers:
                    t.faults = self.fault_injector
            return
        nd = n_devices if n_devices is not None else scenario.n_devices
        na = n_air if n_air is not None else scenario.n_air
        for i, region in enumerate(scenario.regions):
            rng, dynamics = region_streams(seed, i, scenario.dynamics)
            sagin = build_default_sagin(
                n_devices=nd, n_air=na,
                samples_per_device=scenario.samples_per_device,
                alpha=scenario.alpha, seed=region_seed(seed, i))
            if dynamics is not None:
                dynamics.tracer = self.tracer
            self.orchestrators.append(SAGINOrchestrator(
                sagin, intervals=self.intervals[region.name], rng=rng,
                dynamics=dynamics, strategy=scenario.strategy))

    # -- event loop ---------------------------------------------------------
    def run(self, n_rounds: int,
            final_merge: bool = True) -> List[RegionTrace]:
        """Advance every region by ``n_rounds`` MORE, event-stepped: at
        each step the region with the earliest wall clock executes its
        next round (ties broken by region index for determinism; the pop
        sequence is recorded in ``self.step_order``).  In FL mode with a
        merge cadence, the federation policy additionally plans merges
        at round boundaries (see :meth:`_policy_merge`).

        ``run`` CONTINUES from wherever the engine stands (fresh
        engines stand at round 0), so ``run(5); run(5)`` (and an engine
        checkpoint/resume through :mod:`repro_torch.checkpoint`) replays
        ``run(10)`` exactly — provided the first segment passes
        ``final_merge=False`` to suppress the forced off-cadence merge
        at its own last round (an artifact of treating the segment end
        as the end of training).  Cadence-aligned merges key on the
        GLOBAL round index either way.
        """
        if self.trainers:
            return self._run_fl(n_rounds, final_merge)
        self.step_order = []
        if n_rounds <= 0:
            return self.traces
        heap, ends = [], []
        for i, orch in enumerate(self.orchestrators):
            start = len(self.traces[i].records)
            ends.append(start + n_rounds)
            heap.append((orch.wall_clock, i, start))
        heapq.heapify(heap)
        tr = self.tracer
        while heap:
            _, i, r = heapq.heappop(heap)
            self.step_order.append((i, r))
            orch = self.orchestrators[i]
            name = self.scenario.regions[i].name
            if tr.enabled:
                tr.set_context(region=name, round=r, t_sim=orch.wall_clock)
            rec = orch.step(r)
            self.traces[i].records.append(rec)
            if tr.enabled:
                tr.span("round", f"{name}/r{r}", t_sim=rec.wall_clock_start,
                        dur_sim=rec.realized_latency, case=rec.plan.case,
                        latency_analytic=rec.latency,
                        n_handovers=rec.schedule.n_handovers)
            if r + 1 < ends[i]:
                heapq.heappush(heap, (orch.wall_clock, i, r + 1))
        tr.flush()
        return self.traces

    def _run_fl(self, n_rounds: int,
                final_merge: bool = True) -> List[RegionTrace]:
        """FL mode: event-step the region trainers; at merge boundaries
        consult the federation policy — barrier policies park regions
        until all arrive, asynchronous policies plan per trigger."""
        fed = self.federation
        policy = None
        if fed is not None and fed.every is not None:
            from ..fl.federation import get_policy
            policy = get_policy(fed)
        self.step_order = []
        if n_rounds <= 0:
            return self.traces
        starts = {len(t.result.times) for t in self.trainers}
        if len(starts) != 1:
            raise ValueError(f"cannot continue an FL run whose regions "
                             f"stand at unequal round counts: "
                             f"{sorted(starts)}")
        start = starts.pop()
        end = start + n_rounds
        heap = [(t.wall_clock, i, start)
                for i, t in enumerate(self.trainers)]
        heapq.heapify(heap)
        waiting: List[Tuple[int, int]] = []  # (region, next_round) parked
        while heap:
            _, i, r = heapq.heappop(heap)
            self.step_order.append((i, r))
            trainer = self.trainers[i]
            self.traces[i].records.append(trainer.step(r))
            nxt = r + 1
            at_boundary = (policy is not None
                           and (nxt % fed.every == 0
                                or (final_merge and nxt == end)))
            if at_boundary and policy.requires_barrier:
                waiting.append((i, nxt))
                if len(waiting) == len(self.trainers):
                    self._policy_merge(policy, nxt)
                    for j, nr in waiting:
                        if nr < end:
                            heapq.heappush(
                                heap, (self.trainers[j].wall_clock, j, nr))
                    waiting = []
            else:
                if at_boundary:  # asynchronous boundary: no parking
                    self._policy_merge(policy, nxt, trigger=i)
                if nxt < end:
                    heapq.heappush(heap, (trainer.wall_clock, i, nxt))
        if policy is None and self.trainers:
            # no merging: the "global" model is undefined; expose None so
            # callers can tell one-global-model runs from independent ones
            self.global_params = None
        self.tracer.flush()
        return self.traces

    def federation_state(self, barrier_round: int,
                         trigger: Optional[int] = None):
        """Emit the :class:`~repro_torch.fl.federation.FederationState` a
        policy plans from: one snapshot per region (clock, data mass,
        model payload, realized ISL state) plus the boundary context."""
        from ..fl.federation import FederationState
        return FederationState(
            config=self.federation,
            regions=tuple(t.federation_snapshot(i)
                          for i, t in enumerate(self.trainers)),
            barrier_round=barrier_round, trigger=trigger)

    def _policy_merge(self, policy, barrier_round: int,
                      trigger: Optional[int] = None):
        """Plan one merge with the federation policy and execute it:
        aggregate the participants' models, evaluate on and install to
        the plan's recipients (clock := merge time + ISL toll), and
        record the realized :class:`MergeEvent`.  A ``None`` plan skips
        the merge — no models move, no clocks change."""
        from ..fl.client import evaluate

        trainers = self.trainers
        tr = self.tracer
        state = self.federation_state(barrier_round, trigger)
        if tr.enabled:
            for rs in state.regions:
                tr.metrics.gauge(
                    f"federation.isl_scale.{rs.name}").set(rs.isl_scale)
        inj = self.fault_injector
        partitioned = (inj.partition_at(barrier_round)
                       if inj is not None else ())
        if partitioned:
            # injected merge-time ISL partition: retry with capped
            # backoff, then degrade to the partial-quorum plan
            from ..fl.federation import plan_under_partition
            inj.record_injected("isl_partition",
                                regions=list(partitioned),
                                barrier_round=barrier_round)
            plan, delay = plan_under_partition(policy, state, partitioned)
            if plan is not None:
                inj.record_recovered("isl_partition", policy=plan.policy,
                                     delay_s=delay)
        else:
            plan = policy.plan(state)
        if plan is None:
            # a skipped boundary (quorum miss, nothing to do) is itself
            # an observable event — the report CLI surfaces these
            if tr.enabled:
                from ..obs import FEDERATION_TRACK
                tr.span("merge", f"{self.federation.policy}@r{barrier_round}"
                        f" skipped", region=FEDERATION_TRACK,
                        round=barrier_round,
                        t_sim=max(t.wall_clock for t in trainers),
                        skipped=True, policy=self.federation.policy,
                        trigger=trigger)
                tr.metrics.counter("merge.skipped").inc()
            return
        merged = policy.apply([trainers[j].params
                               for j in plan.participants], plan)
        n = len(trainers)
        weights = [0.0] * n
        staleness = [0.0] * n
        costs = [0.0] * n
        accs = [float("nan")] * n
        for j, w, s in zip(plan.participants, plan.weights, plan.staleness):
            weights[j] = float(w)
            staleness[j] = float(s)
        for j, cost in zip(plan.recipients, plan.isl_costs):
            t = trainers[j]
            costs[j] = float(cost)
            _, acc = evaluate(t.apply_fn, merged, t.x_eval, t.y_eval)
            accs[j] = float(acc)
            # every recipient receives the SAME merged pytree; a trainer
            # whose cohort engine donates buffers copies it privately
            # inside install_global before its next round can consume it
            t.install_global(merged, plan.time + cost)
        self.global_params = merged
        if tr.enabled:
            from ..obs import FEDERATION_TRACK
            quorum_miss = len(plan.participants) < len(trainers)
            tr.span("merge", f"{plan.policy}@r{barrier_round}",
                    region=FEDERATION_TRACK, round=barrier_round,
                    t_sim=plan.time, dur_sim=max(costs, default=0.0),
                    policy=plan.policy, hub=plan.hub,
                    participants=list(plan.participants),
                    recipients=list(plan.recipients),
                    recipient_names=[trainers[j]._region_name
                                     for j in plan.recipients],
                    weights=weights, staleness=staleness,
                    # recipient-aligned (skips the NaN accuracy sentinel
                    # of non-recipients: NaN is not valid strict JSON)
                    isl_costs=[costs[j] for j in plan.recipients],
                    accuracies=[accs[j] for j in plan.recipients],
                    quorum_miss=quorum_miss, trigger=trigger)
            m = tr.metrics
            m.counter("merge.count").inc()
            if quorum_miss:
                m.counter("merge.quorum_miss").inc()
            for j, s in zip(plan.participants, plan.staleness):
                m.histogram("merge.staleness_s").observe(float(s))
            for cost in plan.isl_costs:
                m.histogram("merge.isl_cost_s").observe(float(cost))
        self.merges.append(MergeEvent(
            barrier_round=barrier_round, time=plan.time,
            staleness=tuple(staleness), weights=tuple(weights),
            isl_costs=tuple(costs), accuracies=tuple(accs),
            policy=plan.policy, hub=plan.hub,
            participants=tuple(plan.participants),
            recipients=tuple(plan.recipients)))

    # -- results ------------------------------------------------------------
    @property
    def fl_results(self) -> Dict[str, "FLResult"]:
        """FL mode: per-region training curves, keyed by region name."""
        return {t.region.name: tr.result
                for t, tr in zip(self.traces, self.trainers)}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-region headline numbers for reports and benchmarks."""
        out = {}
        for trace in self.traces:
            lats = trace.realized_latencies
            out[trace.region.name] = {
                "rounds": float(len(trace.records)),
                "wall_clock": trace.wall_clock,
                "mean_latency": float(np.mean(lats)) if lats else 0.0,
                "mean_overhead": (float(np.mean(
                    [r.realized_latency - r.latency
                     for r in trace.records])) if lats else 0.0),
            }
        return out


def run_fl_all_regions(cfg, scenario: "Scenario | str", *, params=None):
    """Train one INDEPENDENT FL model per scenario region via ``run_fl``.

    ``params`` replaces the seeded initial model of every region (see
    :class:`~repro_torch.fl.rounds.RegionTrainer`).

    Returns ``{region_name: FLResult}``; each region's result carries the
    realized (dynamics-priced) latencies in its time axis.  Region ``i``
    runs with ``region_index=i`` under the shared root ``cfg.seed``, so
    its data draw and orchestrator/dynamics streams are exactly the ones
    ``SAGINEngine`` region ``i`` sees (``region_seed`` fold) — use
    ``SAGINEngine(scenario, fl=cfg)`` instead when the scenario merges
    regions into one global model.
    """
    import dataclasses as _dc

    from ..fl.rounds import run_fl
    from ..scenarios.registry import SCENARIOS, get_scenario, register
    transient = None
    if isinstance(scenario, str):
        scenario = get_scenario(scenario)
    elif SCENARIOS.get(scenario.name) is not scenario:
        # run_fl resolves by name, so an ad-hoc Scenario must be
        # reachable through the registry for the duration of this call;
        # uniquify on collision (e.g. a replace()d preset keeping its
        # name) and always unregister on the way out
        if scenario.name in SCENARIOS:
            scenario = _dc.replace(scenario,
                                   name=f"{scenario.name}@{id(scenario):x}")
        register(scenario)
        transient = scenario.name
    # one shared tracer across the per-region jobs (each run_fl building
    # its own from cfg.obs would overwrite the same trace file N times)
    from ..obs import resolve_obs
    tracer = resolve_obs(cfg.obs if cfg.obs is not None else scenario.obs)
    out = {}
    try:
        for i, region in enumerate(scenario.regions):
            region_cfg = _dc.replace(cfg, scenario=scenario.name,
                                     region_index=i)
            out[region.name] = run_fl(region_cfg, tracer=tracer,
                                      params=params)
    finally:
        if transient is not None:
            SCENARIOS.pop(transient, None)
    tracer.flush()
    return out
