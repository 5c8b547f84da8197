# Frozen copy of src/repro_torch/core/strategies.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Data-placement strategy hooks for the round orchestrator.

Each strategy is a callable ``(orchestrator, round_index) -> OffloadPlan``
registered under the scheme names of Section VI-A, so the baselines are
executable policies rather than bare strings.  ``SAGINOrchestrator``
accepts either a registered name or any callable with this signature,
which is how experiments plug in custom placement policies.
"""
from __future__ import annotations

from typing import Callable, Dict, TYPE_CHECKING

from . import latency as lat
from .handover import space_latency
from .offloading import (ClusterPlan, OffloadPlan, cluster_case1,
                         evaluate_cluster, evaluate_plan,
                         optimize_offloading)

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from .scheduler import SAGINOrchestrator

StrategyFn = Callable[["SAGINOrchestrator", int], OffloadPlan]

STRATEGIES: Dict[str, StrategyFn] = {}


def register_strategy(name: str):
    def deco(fn: StrategyFn) -> StrategyFn:
        STRATEGIES[name] = fn
        return fn
    return deco


def resolve_strategy(strategy) -> StrategyFn:
    """Name -> hook lookup; callables pass through unchanged."""
    if callable(strategy):
        return strategy
    try:
        return STRATEGIES[strategy]
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; registered: "
                         f"{sorted(STRATEGIES)}") from None


# ---------------------------------------------------------------------------
# The paper's schemes --------------------------------------------------------
# ---------------------------------------------------------------------------
@register_strategy("adaptive")
def plan_adaptive(orch: "SAGINOrchestrator", r: int) -> OffloadPlan:
    """The proposed method: Algorithms 1 & 2 every round."""
    return optimize_offloading(orch.sagin)


@register_strategy("static")
def plan_static(orch: "SAGINOrchestrator", r: int) -> OffloadPlan:
    """Adaptive optimization at round 0 only, then datasets stay frozen."""
    if orch._static_plan is None:
        orch._static_plan = optimize_offloading(orch.sagin)
    if r == 0:
        return orch._static_plan
    return null_plan(orch.sagin)


@register_strategy("none")
def plan_none(orch: "SAGINOrchestrator", r: int) -> OffloadPlan:
    """No data offloading: every node trains on what it already holds."""
    return null_plan(orch.sagin)


@register_strategy("air_ground")
def plan_air_ground(orch: "SAGINOrchestrator", r: int) -> OffloadPlan:
    """Offloading restricted to the air/ground layers (no space moves)."""
    sagin = orch.sagin
    clusters = [cluster_case1(sagin, n, 0.0) for n in sagin.clusters]
    plan = OffloadPlan(case=1, clusters=clusters,
                       new_sat_samples=sagin.n_sat_samples,
                       space_latency=space_latency(sagin.n_sat_samples,
                                                   sagin),
                       round_latency=0.0, baseline_latency=0.0)
    plan.round_latency = evaluate_plan(sagin, plan)
    return plan


@register_strategy("ground_space")
def plan_ground_space(orch: "SAGINOrchestrator", r: int) -> OffloadPlan:
    """Bypass air compute: full optimizer with air nodes as pure relays."""
    sagin = orch.sagin
    saved = [a.f for a in sagin.air_nodes]
    for a in sagin.air_nodes:
        a.f = 1.0  # effectively no compute at air layer
    try:
        plan = optimize_offloading(sagin)
    finally:
        for a, f in zip(sagin.air_nodes, saved):
            a.f = f
    return plan


@register_strategy("proportional")
def plan_proportional(orch: "SAGINOrchestrator", r: int) -> OffloadPlan:
    """Baseline: allocation proportional to each node's compute power."""
    sagin = orch.sagin
    f_sat = sagin.satellites[0].f
    f_total = (sum(d.f for d in sagin.devices)
               + sum(a.f for a in sagin.air_nodes) + f_sat)
    total = sagin.total_samples
    tgt_sat = total * f_sat / f_total
    clusters = []
    sat_delta = tgt_sat - sagin.n_sat_samples
    # distribute the satellite delta across clusters proportionally to
    # their offloadable mass; within each cluster move between air/ground
    offloadable = {n: sum(sagin.devices[k].n_offloadable
                          for k in sagin.clusters[n])
                   + sagin.air_nodes[n].n_samples
                   for n in sagin.clusters}
    off_total = max(1.0, sum(offloadable.values()))
    for n in sagin.clusters:
        cp = ClusterPlan(n=n)
        air = sagin.air_nodes[n]
        ks = sagin.clusters[n]
        if sat_delta > 0:  # clusters send up
            share = sat_delta * offloadable[n] / off_total
            cp.d_air_space = min(share, offloadable[n])
            # take from devices proportionally to their offloadable data
            need = max(0.0, cp.d_air_space - air.n_samples)
            dev_off = max(1.0, sum(sagin.devices[k].n_offloadable
                                   for k in ks))
            for k in ks:
                cp.d_ground_air[k] = (need * sagin.devices[k].n_offloadable
                                      / dev_off)
        else:  # satellite sends down
            share = -sat_delta / len(sagin.clusters)
            cp.d_space_air = share
        clusters.append(cp)
    plan = OffloadPlan(case=2 if sat_delta > 0 else 1, clusters=clusters,
                       new_sat_samples=sagin.n_sat_samples + sum(
                           c.d_air_space - c.d_space_air for c in clusters),
                       space_latency=0.0, round_latency=0.0,
                       baseline_latency=0.0)
    plan.space_latency = space_latency(plan.new_sat_samples, sagin)
    for cp in plan.clusters:
        cp.latency = evaluate_cluster(sagin, cp) + lat.model_upload_time(
            sagin.model_bits, sagin.a2s_rate(cp.n))
    plan.round_latency = evaluate_plan(sagin, plan)
    return plan


def null_plan(sagin) -> OffloadPlan:
    """The no-transfer plan with the current datasets (eq. 16 latency)."""
    clusters = [ClusterPlan(n=n) for n in sagin.clusters]
    plan = OffloadPlan(case=0, clusters=clusters,
                       new_sat_samples=sagin.n_sat_samples,
                       space_latency=space_latency(sagin.n_sat_samples,
                                                   sagin),
                       round_latency=0.0, baseline_latency=0.0)
    for cp in plan.clusters:
        cp.latency = (lat.air_cluster_latency_no_offload(sagin, cp.n)
                      + lat.model_upload_time(sagin.model_bits,
                                              sagin.a2s_rate(cp.n)))
    plan.round_latency = evaluate_plan(sagin, plan)
    return plan
