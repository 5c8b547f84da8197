"""The four built-in federation policies.

====================  ======================================================
``synchronous``       Today's barrier: every region rendezvouses, hub fixed
                      at region 0, data-share weights with the FedMeld-style
                      staleness discount.  Bit-identical to the pre-refactor
                      ``SAGINEngine`` merge (golden-locked in
                      ``tests/test_cross_region.py``).
``soft_async``        FedMeld-style soft dispersal: no barrier.  When a
                      region crosses its own merge boundary it pulls
                      whatever peer models are fresh over live ISLs,
                      merges staleness-discounted, and alone installs the
                      result; peers keep training undisturbed.
``partial``           Barrier that proceeds under ISL outages: only regions
                      whose ISL ran clean in their last round participate
                      (data-mass weights renormalized over the quorum);
                      disconnected regions neither wait nor pay the toll.
                      Skips the merge below ``quorum``.
``elected_hub``       Synchronous rendezvous, but the aggregating hub is
                      elected per merge — by data mass or by live-ISL
                      centrality (Olive-Branch-style topology awareness) —
                      so ISL pricing follows the actual aggregation point.
====================  ======================================================

Every policy prices its own ISL hops from the ``core.latency``
primitives (``isl_path_hops`` / ``global_merge_latency``); the engine no
longer calls the latency model at merge time.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from ...core.latency import global_merge_latency, isl_path_hops, tx_time

from .base import (FederationState, MergePlan, MergePolicy, RegionFedState,
                   register_policy)


def _merge_weights(regions: Sequence[RegionFedState],
                   participants: Sequence[int],
                   staleness: Sequence[float],
                   half_life: Optional[float]) -> Tuple[float, ...]:
    """Data-mass x staleness-discount weights over the participants,
    renormalized (``fl.aggregation.staleness_merge_weights``)."""
    from ..aggregation import staleness_merge_weights
    sizes = [regions[i].data_mass for i in participants]
    w = staleness_merge_weights(sizes, staleness, half_life)
    return tuple(float(x) for x in w)


@register_policy
class SynchronousPolicy(MergePolicy):
    """Full-participation barrier at a fixed hub (region 0)."""
    name = "synchronous"
    requires_barrier = True

    def elect_hub(self, state: FederationState) -> int:
        return 0

    def plan(self, state: FederationState) -> Optional[MergePlan]:
        cfg = self.config
        regions = state.regions
        n = state.n_regions
        hub = self.elect_hub(state)
        participants = tuple(range(n))
        t_merge = max(r.wall_clock for r in regions)
        staleness = tuple(t_merge - r.wall_clock for r in regions)
        weights = _merge_weights(regions, participants, staleness,
                                 cfg.half_life)
        costs = tuple(global_merge_latency(r.model_bits, r.z_isl,
                                           cfg.topology, r.index, n,
                                           hub=hub)
                      for r in regions)
        return MergePlan(policy=self.name, time=t_merge, hub=hub,
                         participants=participants, weights=weights,
                         staleness=staleness, recipients=participants,
                         isl_costs=costs)


@register_policy
class ElectedHubPolicy(SynchronousPolicy):
    """Synchronous barrier with a per-merge elected hub.

    ``elect_by="data_mass"`` puts the aggregation where the most data
    lives (least model mass moves relative to data mass);
    ``elect_by="centrality"`` picks the region with the most live ISLs
    (ties broken by data mass, then lowest index).
    """
    name = "elected_hub"

    def elect_hub(self, state: FederationState) -> int:
        regions = state.regions
        if self.config.elect_by == "centrality":
            degree = state.isl_adjacency().sum(axis=1)
            key = [(-int(degree[r.index]), -r.data_mass, r.index)
                   for r in regions]
        else:  # data_mass
            key = [(-r.data_mass, r.index) for r in regions]
        return min(range(len(regions)), key=key.__getitem__)


@register_policy
class PartialPolicy(MergePolicy):
    """Barrier merge over whatever quorum the ISL dynamics expose.

    Regions whose ISL was degraded in their last round sit the merge
    out entirely: they contribute no model, receive none, pay no toll,
    and — crucially — their wall clocks are NOT dragged to the barrier,
    so an outage never stalls the regions it did not hit.  The data-mass
    weights renormalize over the participating quorum.  The hub is the
    lowest-index live region (region 0 when its link is clean).
    """
    name = "partial"
    requires_barrier = True

    def plan(self, state: FederationState) -> Optional[MergePlan]:
        cfg = self.config
        regions = state.regions
        n = state.n_regions
        live = state.live_regions()
        need = max(2, math.ceil(cfg.quorum * n))
        if len(live) < need:
            return None
        participants = tuple(live)
        hub = live[0]
        t_merge = max(regions[i].wall_clock for i in participants)
        staleness = tuple(t_merge - regions[i].wall_clock
                          for i in participants)
        weights = _merge_weights(regions, participants, staleness,
                                 cfg.half_life)
        costs = tuple(global_merge_latency(regions[i].model_bits,
                                           regions[i].z_isl, cfg.topology,
                                           i, n, hub=hub)
                      for i in participants)
        return MergePlan(policy=self.name, time=t_merge, hub=hub,
                         participants=participants, weights=weights,
                         staleness=staleness, recipients=participants,
                         isl_costs=costs)


@register_policy
class SoftAsyncPolicy(MergePolicy):
    """FedMeld-style soft merge at each region's OWN boundary.

    No rendezvous: the triggering region merges its model with the most
    recent snapshot of every peer reachable over a live ISL, each peer
    discounted by how stale its snapshot is relative to the trigger's
    clock (a peer that is AHEAD of the trigger contributes at zero
    staleness — its model is the freshest thing available).  Only the
    trigger installs the result and pays the fetch: peer models arrive
    in parallel, so the toll is the slowest one-way model transfer.
    Peers' models, clocks, and training are untouched — the global model
    disperses through the constellation instead of being rebuilt at a
    barrier.
    """
    name = "soft_async"
    requires_barrier = False

    def plan(self, state: FederationState) -> Optional[MergePlan]:
        cfg = self.config
        regions = state.regions
        n = state.n_regions
        i = state.trigger
        if i is None:
            raise ValueError("soft_async plans per trigger region; the "
                             "engine must set FederationState.trigger")
        me = regions[i]
        if not me.isl_up:
            return None  # my ISL is down: keep training, merge next time
        peers = [j for j in range(n) if j != i and regions[j].isl_up]
        if not peers:
            return None
        participants = tuple(sorted([i] + peers))
        t_now = me.wall_clock
        staleness = tuple(0.0 if j == i
                          else max(0.0, t_now - regions[j].wall_clock)
                          for j in participants)
        weights = _merge_weights(regions, participants, staleness,
                                 cfg.half_life)
        fetch = max(isl_path_hops(cfg.topology, j, i, n)
                    * tx_time(regions[j].model_bits, regions[j].z_isl)
                    for j in peers)
        return MergePlan(policy=self.name, time=t_now, hub=i,
                         participants=participants, weights=weights,
                         staleness=staleness, recipients=(i,),
                         isl_costs=(fetch,))


def plan_under_partition(policy: MergePolicy, state: FederationState,
                         partitioned: Sequence[int],
                         max_retries: int = 3,
                         backoff_base: float = 5.0,
                         backoff_cap: float = 60.0
                         ) -> Tuple[Optional[MergePlan], float]:
    """Plan a merge while the ISLs of ``partitioned`` regions are down
    (a fault-injected merge-time partition, ``repro_torch.resilience``).

    The degraded state marks the partitioned regions' ISLs dead
    (``isl_scale=0``).  Policies that already tolerate outages
    (``partial``; ``soft_async`` plans per trigger) simply plan on the
    degraded state at zero extra cost.  Barrier policies that REQUIRE
    full participation (``synchronous`` / ``elected_hub``) first retry
    the rendezvous ``max_retries`` times with capped exponential backoff
    (``min(backoff_base * 2^k, backoff_cap)`` seconds of simulated ISL
    re-probing per attempt — the partition is modeled as outlasting the
    retry budget), then degrade gracefully to the ``partial`` policy's
    quorum plan over the connected regions.

    Returns ``(plan, delay)``: the (possibly fallback) plan with the
    retry delay already folded into its merge instant, or ``None`` when
    even the quorum fails — plus the simulated seconds burned retrying.
    """
    import dataclasses as _dc

    partitioned = set(partitioned)
    degraded = _dc.replace(state, regions=tuple(
        _dc.replace(r, isl_scale=0.0) if r.index in partitioned else r
        for r in state.regions))
    tolerant = (not policy.requires_barrier
                or isinstance(policy, PartialPolicy))
    if tolerant or not partitioned:
        return policy.plan(degraded), 0.0
    delay = sum(min(backoff_base * (2.0 ** k), backoff_cap)
                for k in range(max_retries))
    fallback = PartialPolicy(policy.config)
    plan = fallback.plan(degraded)
    if plan is None:
        return None, delay
    return _dc.replace(plan, time=plan.time + delay), delay


def _policy_names() -> List[str]:  # pragma: no cover - debug helper
    from .base import list_policies
    return list_policies()
