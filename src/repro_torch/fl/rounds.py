"""End-to-end FL simulation driver (Section VI), on PyTorch.

Couples the analytic SAGIN orchestration (latency, offloading, handover)
with real federated training on a (synthetic) dataset: every node that
holds samples runs H local SGD iterations, models are aggregated with the
eq.-(13) lambda weights, and the wall clock advances by the optimized
round latency.  Produces accuracy-versus-training-time curves.

:class:`RegionTrainer` is one region's FL job, advanced one round at a
time by :meth:`RegionTrainer.step`; :func:`run_fl` steps a trainer
``n_rounds`` times, and the multi-region
:class:`~repro_torch.sim.engine.SAGINEngine` steps many trainers through
its event heap and merges their models across regions.  All run on
``FLConfig.device`` (``"cuda"`` by default) and raise when CUDA is asked
for and absent.

Region addressing: with a scenario, all of a region's streams — dataset
sample draw, partition shuffle, orchestrator satellite draws, dynamics
events — are rooted at ``region_seed(cfg.seed, cfg.region_index)``
(:func:`repro_torch.sim.engine.region_streams`), so
``run_fl(FLConfig(scenario=s, region_index=i))`` reproduces engine
region ``i`` exactly.  The model init alone stays keyed on the global
``cfg.seed``: every region descends from one broadcast initial model.

Execution modes (``FLConfig.execution``):

* ``"batched"`` — the cohort engine
  (:class:`repro_torch.fl.cohort_engine.CohortEngine`): every
  data-holding node's (H, B) batch stack is drawn through the shared RNG
  stream and partitioned into geometric batch-width buckets; each
  occupied bucket trains in one vmapped ``cohort_local_update`` and the
  buckets' stacked params aggregate in one ``fedavg_stacked_multi`` call
  (the Hopper ``fedavg_agg`` kernel on the card).
  ``cohort_bucketing="global"`` keeps the single global-``Bmax`` layout
  for comparison.
* ``"sequential"`` — the reference loop: one ``local_update`` per node,
  then ``fedavg`` over the list of models.
* ``"auto"`` (default) — ``"batched"`` on CUDA, ``"sequential"`` on the
  CPU.

Both modes draw mini-batches from the same NumPy RNG stream in the same
node order (ground 0..K-1, then air, then satellite), and so does the
reference: at equal seeds and equal initial params, the latencies, wall
clocks and plan cases are identical to the reference's, and accuracies
agree up to float reduction-order noise.

Fault injection (``repro_torch.resilience``): a trainer with an attached
``FaultInjector`` absorbs satellite loss and stragglers as realized
latency, warm-restarts after a trainer crash, and quarantines non-finite
client updates before the aggregate.

``guard_recompiles=True`` runs every warm round of the cohort engine
under ``analysis.contracts.no_recompile`` (``CohortEngine(guard=True)``).

Several GPUs (``cohort_sharding="mesh"``, or ``"auto"`` under a process
group of more than one rank): start one process a GPU (``torchrun
--nproc-per-node N``), and in each call ``init_process_group`` and
``torch.cuda.set_device(local_rank)`` before ``run_fl``.  Every rank
runs the same NumPy control plane from the same seeds (plans, clocks,
batches and evaluation are the same on every rank, and so is the
returned ``FLResult``), while the batched engine splits each bucket's
clients over the ranks and joins them in an all-reduce (see
:mod:`~repro_torch.fl.cohort_engine`).  Only rank 0 writes the ``obs``
trace: the other ranks hold the null tracer, so N ranks do not write N
copies of one file.  Without a group, or in a group of one, nothing
changes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

import numpy as np
import torch

from ..core import SAGINOrchestrator, build_default_sagin
from ..core.handover import replan_after_loss
from ..core.network import SAGIN
from ..data import FederatedPools, make_dataset, partition
from ..device import resolve_device
from ..models.cnn import build_model, model_bits
from ..launch.mesh import group_rank
from ..obs import NULL_TRACER, resolve_obs
from ..tree import tree_map
from .aggregation import fedavg, fedavg_stacked, tree_all_finite
from .client import cohort_local_update, evaluate, local_update
from .cohort_engine import CohortEngine, cohort_tensors
from .federation import FederationConfig, RegionFedState

if TYPE_CHECKING:  # pragma: no cover - circular-import guard
    from ..core.constellation import AccessInterval
    from ..scenarios.registry import Scenario
    from ..serve.workload import ServeConfig


@dataclasses.dataclass
class FLConfig:
    dataset: str = "mnist"
    iid: bool = True
    alpha: float = 0.8
    n_devices: int = 50
    n_air: int = 5
    n_rounds: int = 30
    h_local: int = 5
    lr: float = 0.05
    batch_cap: int = 32
    strategy: str = "adaptive"     # adaptive|none|air_ground|ground_space|static|proportional
    rayleigh: bool = True
    train_fraction: float = 0.05   # shrink dataset for fast runs
    eval_size: int = 1024
    seed: int = 0
    use_constellation: bool = False  # True: drive T_i from Walker-Star
    scenario: Optional[str] = None   # named preset (repro_torch.scenarios)
    region_index: int = 0            # which scenario region this FL job serves
    execution: str = "auto"        # auto|batched|sequential (module docstring)
    cohort_batch_align: int = 32   # batched mode: bucket-width grid unit
    cohort_bucketing: str = "geometric"  # geometric|global (module docstring)
    cohort_client_align: int = 4   # batched mode: bucket client-count grid
    guard_recompiles: bool = False  # warm cohort rounds under no_recompile
    # batched mode: shard each bucket's client axis over the ranks of a
    # torch.distributed mesh ("mesh"), never shard ("off"), or shard
    # exactly when a group of more than one rank is up ("auto")
    cohort_sharding: str = "auto"  # auto|mesh|off
    # Cross-region federation override for SAGINEngine FL mode: a
    # FederationConfig replaces the scenario's wholesale; a bare policy
    # name (e.g. "soft_async") keeps the scenario's cadence/topology/
    # half-life and swaps only the policy; None defers to the scenario.
    # Ignored by single-region run_fl (nothing to merge with).
    federation: Optional["FederationConfig | str"] = None
    # Observability: an ObsConfig, a bare JSONL output path string, or
    # None (disabled — the default, a no-op null tracer).
    obs: Optional[object] = None
    # Serving-gateway wiring (repro_torch.serve): a ServeConfig shaping
    # the request workload / router / batching a ServeGateway attached
    # to this run uses.  Wins over Scenario.serve; None defers to the
    # scenario (and ultimately to ServeConfig() defaults).  Training
    # itself never reads this — serving is strictly read-only.
    serve: Optional["ServeConfig"] = None
    # Quarantine non-finite client updates before aggregation (weights
    # renormalize over the finite survivors).  None (default) arms it
    # exactly when a fault injector is attached (the chaos path); True/
    # False force it either way.
    quarantine: Optional[bool] = None
    device: str = "cuda"           # where the job runs; no CPU fallback

    def __post_init__(self):
        if self.serve is not None:
            from ..serve.gateway import resolve_serve
            resolve_serve(self.serve)   # raises unless a ServeConfig

    def resolved_execution(self) -> str:
        if self.execution == "auto":
            return ("batched" if torch.device(self.device).type == "cuda"
                    else "sequential")
        return self.execution


@dataclasses.dataclass
class FLResult:
    config: FLConfig
    times: List[float]             # cumulative training time (s)
    accuracies: List[float]        # on the held-out eval batch
    losses: List[float]            # mean TRAIN loss across this round's
    #                              training nodes; NaN for a round in which
    #                              no node trained
    latencies: List[float]         # realized per-round latency
    cases: List[int]
    layer_portions: List[Dict[str, float]]  # data share per layer per round
    # True when >= 1 node trained in the round (equivalently: losses[r]
    # is finite)
    participated: List[bool] = dataclasses.field(default_factory=list)

    def time_to_accuracy(self, target: float) -> Optional[float]:
        for t, a in zip(self.times, self.accuracies):
            if a >= target:
                return t
        return None


def _build_orchestrator(cfg: FLConfig, sagin: SAGIN,
                        scenario: Optional["Scenario"] = None,
                        intervals: Optional[Sequence["AccessInterval"]] = None
                        ) -> SAGINOrchestrator:
    """Orchestrator from the config: scenario preset, bare Walker-Star, or
    the static satellite list, in that order of precedence.

    With a scenario, coverage windows come from the vectorized
    multi-region propagation pass and the preset's stochastic dynamics
    are attached, so the wall clock advances by *realized* latencies.
    The engine passes ``scenario``/``intervals`` explicitly to share one
    propagation pass (and to support unregistered ad-hoc scenarios); a
    standalone job resolves the preset by name and propagates only its
    own region (NumPy: window boundaries are control-plane state).
    """
    if cfg.scenario is not None or scenario is not None:
        from ..sim.engine import region_streams
        from ..sim.propagation import access_intervals_multi

        scn = scenario if scenario is not None else _resolve_scenario(cfg)
        try:
            region = scn.regions[cfg.region_index]
        except IndexError:
            raise ValueError(
                f"scenario {scn.name!r} has {len(scn.regions)} region(s); "
                f"region_index={cfg.region_index} is out of range") from None
        if intervals is None:
            intervals = access_intervals_multi(
                scn.build_constellation(), [region], t_end=scn.horizon,
                dt=scn.dt)[region.name]
        rng, dynamics = region_streams(cfg.seed, cfg.region_index,
                                       scn.dynamics)
        # an explicitly non-default FLConfig.strategy wins; otherwise the
        # scenario's declared scheme applies (as in SAGINEngine)
        strategy = (cfg.strategy if cfg.strategy != "adaptive"
                    else scn.strategy)
        return SAGINOrchestrator(sagin, intervals=intervals, rng=rng,
                                 dynamics=dynamics, strategy=strategy)
    constellation = None
    if cfg.use_constellation:
        from ..core import WalkerStar
        constellation = WalkerStar()
    return SAGINOrchestrator(sagin, constellation=constellation,
                             sat_f_seed=cfg.seed, strategy=cfg.strategy)


def _resolve_scenario(cfg: FLConfig) -> "Scenario":
    from ..scenarios import get_scenario
    return get_scenario(cfg.scenario)


def _train_node(apply_fn, params, ds, idx, h, lr, batch_cap, rng, device):
    from ..data.pipeline import batch_for_local_steps
    batches = batch_for_local_steps(ds.x_train, ds.y_train, idx, h, rng,
                                    max_batch=batch_cap)
    if batches is None:
        return None
    xs, ys = batches
    new_params, loss = local_update(
        apply_fn, params, torch.from_numpy(xs).to(device),
        torch.from_numpy(ys).to(device=device, dtype=torch.int64), lr)
    return new_params, float(loss)


def _node_pools(cfg: FLConfig, pools, offline=()) -> List[np.ndarray]:
    """Index pools of every data-holding node, in canonical node order
    (ground 0..K-1, air 0..N-1, satellite) — the order both execution
    modes must share for RNG-stream equivalence.  Devices churned out
    for the round (``offline``) sit out of training entirely."""
    out = []
    offline = set(offline)
    for k in range(cfg.n_devices):
        if k in offline:
            continue
        idx = pools.ground_all(k)
        if len(idx):
            out.append(idx)
    for n in range(cfg.n_air):
        if len(pools.air[n]):
            out.append(pools.air[n])
    if len(pools.sat):
        out.append(pools.sat)
    return out


def _round_sequential(cfg: FLConfig, apply_fn, params, ds, node_pools,
                      total, rng, device, corrupt=(), quarantine=False):
    """Reference loop: one local update per node, then ``fedavg``.

    Returns ``(params, losses, n_quarantined)``.  ``corrupt`` holds the
    canonical node positions whose trained models are NaN-filled AFTER
    training (fault injection; RNG draws untouched); with ``quarantine``
    any non-finite model is dropped before ``fedavg`` — the weights
    renormalize over the survivors, and a round whose every update was
    dropped keeps the previous global model.
    """
    corrupt = set(corrupt)
    new_models, weights, losses = [], [], []
    n_quarantined = 0
    for pos, idx in enumerate(node_pools):
        out = _train_node(apply_fn, params, ds, idx, cfg.h_local,
                          cfg.lr, cfg.batch_cap, rng, device)
        if out is None:
            continue
        model, loss = out
        if pos in corrupt:
            model = tree_map(lambda a: torch.full_like(a, float("nan")),
                             model)
            loss = float("nan")
        if quarantine and not tree_all_finite(model):
            n_quarantined += 1
            continue
        new_models.append(model)
        weights.append(len(idx) / total)
        losses.append(loss)
    if new_models:
        params = fedavg(new_models, weights)
    return params, losses, n_quarantined


def _round_batched(cfg: FLConfig, apply_fn, params, ds, node_pools,
                   total, rng, engine: CohortEngine, corrupt=(),
                   quarantine=False):
    """Cohort engine: size-bucketed vmapped local updates + one stacked
    eq.-(13) aggregate (the Hopper ``fedavg_agg`` kernel on the card).
    ``cfg.cohort_bucketing="global"`` keeps the single global-``Bmax``
    layout for comparison.

    Returns ``(params, losses, n_quarantined)``; ``corrupt`` /
    ``quarantine`` are the fault-injection and non-finite-update gates
    of :meth:`~repro_torch.fl.cohort_engine.CohortEngine.round`
    (geometric bucketing only — the comparison-grade global layout has
    no quarantine hook).
    """
    if cfg.cohort_bucketing == "global":
        if corrupt or quarantine:
            raise ValueError(
                "fault injection / quarantine require "
                "cohort_bucketing='geometric'; the 'global' comparison "
                "layout has no masking hook")
        from ..data.pipeline import build_cohort
        cohort = build_cohort(ds.x_train, ds.y_train, node_pools,
                              cfg.h_local, rng, max_batch=cfg.batch_cap,
                              pad_clients=cfg.n_devices + cfg.n_air + 1,
                              batch_align=cfg.cohort_batch_align)
        if cohort is None:
            return params, [], 0
        xs, ys, mask = cohort_tensors(cohort, engine.device)
        stacked, client_losses = cohort_local_update(apply_fn, params, xs,
                                                     ys, mask, cfg.lr)
        weights = torch.from_numpy(
            (cohort.sizes / total).astype(np.float32)).to(engine.device)
        params = fedavg_stacked(stacked, weights)
        valid = cohort.sizes > 0
        losses = [float(v) for v in client_losses.cpu().numpy()[valid]]
        return params, losses, 0
    if cfg.cohort_bucketing != "geometric":
        raise ValueError(f"FLConfig.cohort_bucketing must be 'geometric' "
                         f"or 'global', got {cfg.cohort_bucketing!r}")
    cohort = engine.build(ds.x_train, ds.y_train, node_pools, cfg.h_local,
                          rng, max_batch=cfg.batch_cap)
    if cohort is None:
        return params, [], 0
    params, losses = engine.round(params, cohort, cfg.lr, total,
                                  corrupt=corrupt, quarantine=quarantine)
    return params, losses, engine.last_quarantined


class RegionTrainer:
    """One region's complete FL job, advanced one round at a time.

    Owns the region's dataset, index pools, model parameters, and SAGIN
    orchestrator; :meth:`step` executes one full round (orchestration,
    data placement, local training, aggregation, evaluation) and appends
    to :attr:`result`.  Construction draws from the region's NumPy RNG in
    the reference's order, so at equal seeds the port and the reference
    see the same data, pools, plans and batches.

    The engine passes ``scenario``/``intervals`` so every region shares
    one propagation pass; standalone use needs only the config.  After a
    cross-region merge the engine calls :meth:`install_global` to adopt
    the global model and the post-merge wall clock.

    ``params`` (a parameter tree in the port's layout, e.g. from
    :func:`repro_torch.convert.params_from_jax`) replaces the seeded
    initial model; it is copied onto the job's device.
    """

    def __init__(self, cfg: FLConfig,
                 scenario: Optional["Scenario"] = None,
                 intervals: Optional[Sequence["AccessInterval"]] = None,
                 tracer=None, *, params=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.execution = cfg.resolved_execution()
        if self.execution not in ("batched", "sequential"):
            raise ValueError(
                f"FLConfig.execution must be 'auto', 'batched' or "
                f"'sequential', got {cfg.execution!r}")
        scn = scenario
        if scn is None and cfg.scenario is not None:
            scn = _resolve_scenario(cfg)
        # an explicit tracer (the engine's shared one) wins over the
        # config; scenario-level obs applies when the config is silent
        if tracer is None:
            obs = cfg.obs
            if obs is None and scn is not None:
                obs = scn.obs
            # one trace for all ranks of a group: rank 0's
            tracer = resolve_obs(obs) if group_rank() == 0 else NULL_TRACER
        self.tracer = tracer
        if scn is not None:
            from ..sim.engine import region_seed
            rseed = region_seed(cfg.seed, cfg.region_index)
            self.region = (scn.regions[cfg.region_index]
                           if cfg.region_index < len(scn.regions) else None)
        else:
            rseed = cfg.seed
            self.region = None
        self.region_seed = rseed
        self.rng = np.random.default_rng(rseed)
        # regions share the TASK (class prototypes keyed on the global
        # seed) but draw disjoint-by-construction sample streams
        self.ds = make_dataset(cfg.dataset, seed=cfg.seed,
                               train_fraction=cfg.train_fraction,
                               sample_seed=rseed)
        parts = partition(self.ds, n_devices=cfg.n_devices, iid=cfg.iid,
                          alpha=cfg.alpha, seed=rseed)
        self.pools = FederatedPools.from_partitions(parts, cfg.n_air)

        # model init is keyed on the GLOBAL seed: every region descends
        # from the same broadcast initial model (merge prerequisite)
        self.params, self.apply_fn = build_model(
            self.ds.name, cfg.seed, self.device,
            image_shape=self.ds.x_train.shape[1:])
        if params is not None:
            self.params = tree_map(
                lambda t: t.detach().to(self.device, copy=True), params)
        self.sagin = build_default_sagin(
            n_devices=cfg.n_devices, n_air=cfg.n_air, alpha=cfg.alpha,
            q_bits=self.ds.sample_bits, model_bits=model_bits(self.params),
            rayleigh=cfg.rayleigh, seed=rseed)
        # sync actual per-device sizes into the network model
        for k, p in enumerate(parts):
            self.sagin.devices[k].n_samples = p.n_samples
            self.sagin.devices[k].n_sensitive = p.n_sensitive

        self.orch = _build_orchestrator(cfg, self.sagin, scenario=scn,
                                        intervals=intervals)
        self._region_name = (self.region.name if self.region is not None
                             else f"region{cfg.region_index}")
        # fault injection (repro_torch.resilience): the engine attaches
        # its shared FaultInjector here; None = clean run, zero overhead
        self.faults = None
        # last realized ISL scale, read by the federation snapshot
        self._last_isl_scale = 1.0
        if self.orch.dynamics is not None:
            self.orch.dynamics.tracer = self.tracer

        self.cohort_engine = None
        if self.execution == "batched":
            self.cohort_engine = CohortEngine(
                self.apply_fn, batch_align=cfg.cohort_batch_align,
                client_align=cfg.cohort_client_align, device=self.device,
                tracer=self.tracer, sharding=cfg.cohort_sharding,
                guard=cfg.guard_recompiles)

        self.result = FLResult(cfg, [], [], [], [], [], [])
        eval_idx = self.rng.choice(len(self.ds.x_test),
                                   size=min(cfg.eval_size,
                                            len(self.ds.x_test)),
                                   replace=False)
        self.x_eval = torch.from_numpy(self.ds.x_test[eval_idx]).to(
            self.device)
        self.y_eval = torch.from_numpy(self.ds.y_test[eval_idx]).to(
            device=self.device, dtype=torch.int64)

    @property
    def wall_clock(self) -> float:
        return self.orch.wall_clock

    @property
    def total_samples(self) -> int:
        """This region's data mass (constant: offloading conserves it)."""
        return self.pools.total()

    def federation_snapshot(self, index: int) -> RegionFedState:
        """This region's view for federation-policy planning: clock,
        data mass, model payload, and the ISL state its dynamics
        realized in the last completed round.  The trainer emits state;
        merge SEMANTICS live entirely in ``repro_torch.fl.federation``."""
        return RegionFedState(
            index=index,
            name=self.region.name if self.region is not None else str(index),
            wall_clock=self.orch.wall_clock,
            data_mass=float(self.total_samples),
            model_bits=float(self.sagin.model_bits),
            z_isl=float(self.sagin.z_isl),
            isl_scale=self._last_isl_scale,
            rounds_done=len(self.result.times))

    def install_global(self, params, wall_clock: float):
        """Adopt the post-merge global model and post-merge clock; the
        next :meth:`step` resumes local training from the global model.

        The engine hands the SAME merged tree to every recipient (and a
        one-participant merge hands over a trainer's own params), so
        each recipient keeps a private copy: no tensor is then shared
        between two regions, whatever a later round does with it."""
        self.params = tree_map(lambda t: t.clone(), params)
        self.orch.wall_clock = wall_clock

    def step(self, r: int):
        """Execute FL round ``r``: orchestrate, place data, train every
        data-holding node, aggregate, evaluate.  Returns the round's
        :class:`~repro_torch.core.scheduler.RoundRecord` and appends the
        training metrics to :attr:`result`."""
        cfg = self.cfg
        tr = self.tracer
        if tr.enabled:
            # context BEFORE orch.step: dynamics samples (and emits
            # `outage` events) inside it, at this round's start clock
            tr.set_context(region=self._region_name, round=r,
                           t_sim=self.orch.wall_clock)
        rec = self.orch.step(r)
        specs = (self.faults.at(r, cfg.region_index)
                 if self.faults is not None else ())
        crash = self._apply_latency_faults(rec, specs)
        _apply_plan_to_pools(rec.plan, self.pools, self.sagin)
        _sync_sizes(self.pools, self.sagin)

        # ---- local training at every node that holds data ----------------
        total = self.pools.total()
        node_pools = _node_pools(cfg, self.pools,
                                 offline=rec.offline_devices)
        # nan_update: the first ceil(severity) canonical nodes' trained
        # models are NaN-filled AFTER training (the RNG stream is
        # untouched, so the chaos trajectory stays seed-reproducible)
        nan_spec = next((s for s in specs if s.kind == "nan_update"), None)
        corrupt: Sequence[int] = ()
        if nan_spec is not None and node_pools:
            n_bad = min(max(1, int(nan_spec.severity)), len(node_pools))
            corrupt = tuple(range(n_bad))
        quarantine = (cfg.quarantine if cfg.quarantine is not None
                      else self.faults is not None)
        if crash is not None:
            # trainer process died mid-round: the round's training is
            # lost, recovery warm-restarts from the last committed model
            # (params unchanged) after a restart penalty on the clock
            penalty = crash.severity * rec.realized_latency
            self.faults.record_injected("trainer_crash",
                                        penalty_s=penalty)
            rec.realized_latency += penalty
            self.orch.wall_clock += penalty
            losses, n_quar = [], 0
            self.faults.record_recovered("trainer_crash",
                                         penalty_s=penalty)
        elif self.execution == "batched":
            self.params, losses, n_quar = _round_batched(
                cfg, self.apply_fn, self.params, self.ds, node_pools,
                total, self.rng, self.cohort_engine, corrupt=corrupt,
                quarantine=quarantine)
        else:
            self.params, losses, n_quar = _round_sequential(
                cfg, self.apply_fn, self.params, self.ds, node_pools,
                total, self.rng, self.device, corrupt=corrupt,
                quarantine=quarantine)
        if corrupt and self.faults is not None:
            self.faults.record_injected("nan_update",
                                        n_corrupt=len(corrupt))
            if quarantine and n_quar >= len(corrupt):
                self.faults.record_recovered("nan_update",
                                             quarantined=n_quar)
        if n_quar:
            tr.metrics.counter("quarantine.updates").inc(n_quar)

        _, acc = evaluate(self.apply_fn, self.params, self.x_eval,
                          self.y_eval)
        res = self.result
        res.times.append(self.orch.wall_clock)
        res.accuracies.append(float(acc))
        res.losses.append(float(np.mean(losses)) if losses
                          else float("nan"))
        res.participated.append(bool(losses))
        res.latencies.append(rec.realized_latency)
        res.cases.append(rec.plan.case)
        n_ground = sum(len(self.pools.ground_all(k))
                       for k in range(cfg.n_devices))
        n_air = sum(len(a) for a in self.pools.air)
        res.layer_portions.append({
            "ground": n_ground / total, "air": n_air / total,
            "space": len(self.pools.sat) / total})
        self._last_isl_scale = (float(rec.events.isl_scale)
                                if rec.events is not None else 1.0)
        if tr.enabled:
            self._emit_round_spans(r, rec, res)
        return rec

    def _apply_latency_faults(self, rec, specs):
        """Apply this round's latency-shaped faults to the round record
        and the wall clock; returns the ``trainer_crash`` spec (handled
        at the training dispatch) or ``None``.

        ``sat_loss`` kills the serving satellite at
        ``severity * tau_S`` into the space schedule and re-plans onto
        the successor chain
        (:func:`repro_torch.core.handover.replan_after_loss` — the
        unplanned mid-window handover); ``straggler`` stretches the
        realized round latency by ``severity``x.  Both are absorbed as
        extra realized latency — the round still completes, which IS the
        recovery."""
        crash = None
        for spec in specs:
            if spec.kind == "sat_loss":
                loss_t = spec.severity * rec.schedule.total_latency
                recovered, _ = replan_after_loss(rec.schedule, loss_t,
                                                 self.sagin)
                delta = max(0.0, recovered.total_latency
                            - rec.schedule.total_latency)
                self.faults.record_injected("sat_loss", loss_time=loss_t,
                                            delta_s=delta)
                rec.schedule = recovered
                rec.realized_latency += delta
                self.orch.wall_clock += delta
                self.faults.record_recovered("sat_loss", delta_s=delta)
            elif spec.kind == "straggler":
                delta = max(0.0, (spec.severity - 1.0)
                            * rec.realized_latency)
                self.faults.record_injected("straggler",
                                            slowdown=spec.severity)
                rec.realized_latency += delta
                self.orch.wall_clock += delta
                self.faults.record_recovered("straggler", delta_s=delta)
            elif spec.kind == "trainer_crash":
                crash = spec
        return crash

    def _emit_round_spans(self, r: int, rec, res: FLResult):
        """Trace one completed round: offload transfer, handover legs,
        and the round span itself (enabled path only).  Purely
        observational — reads the round record, writes spans."""
        tr = self.tracer
        t0 = rec.wall_clock_start
        plan = rec.plan
        q_bits = float(self.sagin.q_bits)
        up = sum(sum(cp.d_ground_air.values()) + cp.d_air_space
                 for cp in plan.clusters)
        down = sum(sum(cp.d_air_ground.values()) + cp.d_space_air
                   for cp in plan.clusters)
        tr.span("offload", f"offload case{plan.case}", t_sim=t0,
                case=plan.case, up_samples=up, down_samples=down,
                bytes_moved=(up + down) * q_bits / 8.0)
        tr.metrics.counter("offload.bytes").inc((up + down) * q_bits / 8.0)
        tr.metrics.counter("offload.samples_up").inc(up)
        tr.metrics.counter("offload.samples_down").inc(down)

        sched = rec.schedule
        prev = None
        for leg in sched.legs:
            if prev is not None and leg.handover_delay > 0:
                tr.span("handover", f"sat{prev}->sat{leg.sat_index}",
                        t_sim=t0 + leg.start_time - leg.handover_delay,
                        dur_sim=leg.handover_delay,
                        samples=leg.samples_processed)
            prev = leg.sat_index
        if sched.n_handovers:
            tr.metrics.counter("handover.count").inc(sched.n_handovers)

        ev = rec.events
        uplink_delay = (sum(ev.uplink_delays.values())
                        if ev is not None else 0.0)
        tr.span("round", f"{self._region_name}/r{r}", t_sim=t0,
                dur_sim=rec.realized_latency,
                case=plan.case, latency_analytic=rec.latency,
                # the no-participant loss sentinel is NaN — not valid
                # strict JSON, so map it to None in the trace
                loss=(res.losses[-1] if res.participated[-1] else None),
                acc=res.accuracies[-1],
                participated=res.participated[-1],
                n_handovers=sched.n_handovers, t_space=sched.total_latency,
                uplink_delay=uplink_delay)
        tr.metrics.histogram("round.realized_latency_s").observe(
            rec.realized_latency)
        tr.metrics.histogram("round.overhead_s").observe(
            rec.realized_latency - rec.latency)


def run_fl(cfg: FLConfig, tracer=None, *, params=None) -> FLResult:
    """Single-region FL job: a :class:`RegionTrainer` stepped to the end.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) overrides ``cfg.obs``
    — ``run_fl_all_regions`` shares one tracer across regions this way;
    when this function owns the tracer it also flushes the trace at the
    end.  ``params`` replaces the seeded initial model (see
    :class:`RegionTrainer`).
    """
    own_tracer = tracer is None
    trainer = RegionTrainer(cfg, tracer=tracer, params=params)
    for r in range(cfg.n_rounds):
        trainer.step(r)
    if own_tracer:
        trainer.tracer.flush()
    return trainer.result


def _apply_plan_to_pools(plan, pools: FederatedPools, sagin: SAGIN):
    """Mirror the optimizer's (fractional) plan as integer index moves."""
    for cp in plan.clusters:
        n = cp.n
        # downward: satellite -> air -> ground
        if cp.d_space_air > 0:
            pools.move_sat_to_air(n, int(round(cp.d_space_air)))
        for k, d in sorted(cp.d_air_ground.items()):
            pools.move_air_to_ground(n, k, int(round(d)))
        # upward: ground -> air -> satellite
        for k, d in sorted(cp.d_ground_air.items()):
            pools.move_ground_to_air(k, n, int(round(d)))
        if cp.d_air_space > 0:
            pools.move_air_to_sat(n, int(round(cp.d_air_space)))


def _sync_sizes(pools: FederatedPools, sagin: SAGIN):
    """Make the analytic model's sizes match the realized pools."""
    for k, dev in enumerate(sagin.devices):
        dev.n_samples = len(pools.ground_all(k))
        dev.n_sensitive = len(pools.ground_sensitive[k])
    for n, air in enumerate(sagin.air_nodes):
        air.n_samples = len(pools.air[n])
    sagin.n_sat_samples = len(pools.sat)
