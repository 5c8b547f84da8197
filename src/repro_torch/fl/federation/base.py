"""Federation-policy API: WHO merges WHAT, WHEN, at WHAT ISL price.

The cross-region merge used to be an if-branch inside
:class:`~repro_torch.sim.engine.SAGINEngine`: a hard-coded full-participation
barrier with a fixed hub at region 0.  This module turns that decision
surface into data:

* :class:`FederationConfig` — the declarative knob set (policy name,
  cadence, ISL topology, staleness half-life, quorum, hub election
  criterion), threaded through ``Scenario.federation`` and
  ``FLConfig.federation``.
* :class:`FederationState` — everything the engine knows at a merge
  boundary: per-region wall clocks (hence model ages), data masses,
  and the live ISL state realized by ``sim.dynamics``.  The engine
  EMITS this; it no longer knows merge semantics.
* :class:`MergePlan` — a policy's decision: participants, normalized
  weights, staleness, recipients, the elected hub, and the per-recipient
  ISL price.  The engine installs whatever the plan says.
* :class:`MergePolicy` — ``plan(state) -> MergePlan | None`` plus
  ``apply(models, plan)``, which rides the existing stacked
  aggregation path (``fedavg_stacked``, the single-stack form of
  ``fedavg_stacked_multi`` — the Hopper ``fedavg_agg`` kernel on the
  card).

Policies register by name (:func:`register_policy`); see
``repro_torch.fl.federation.policies`` for the four built-ins
(``synchronous``, ``soft_async``, ``partial``, ``elected_hub``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Type, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ...scenarios.registry import Scenario

ELECTION_CRITERIA = ("data_mass", "centrality")


@dataclasses.dataclass(frozen=True)
class FederationConfig:
    """Declarative cross-region federation knobs.

    ``every=None`` disables merging entirely (independent per-region
    models, the historic ``merge_every=None`` behavior); otherwise the
    engine consults the named policy at every ``every``-round boundary
    (and at the final round).  ``quorum`` and ``elect_by`` are only read
    by the policies that need them (``partial`` / ``elected_hub``).
    """
    policy: str = "synchronous"
    every: Optional[int] = None         # merge cadence in rounds
    topology: str = "ring"              # base ISL route ("ring" | "star")
    half_life: Optional[float] = None   # staleness discount half-life (s)
    quorum: float = 0.5                 # partial: min live fraction to merge
    elect_by: str = "data_mass"         # elected_hub: data_mass | centrality

    def __post_init__(self):
        from ...core.latency import MERGE_TOPOLOGIES
        if self.every is not None and self.every < 1:
            raise ValueError(f"federation every must be a positive round "
                             f"count or None, got {self.every}")
        if self.topology not in MERGE_TOPOLOGIES:
            raise ValueError(f"federation topology must be one of "
                             f"{MERGE_TOPOLOGIES}, got {self.topology!r}")
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"federation quorum must be in (0, 1], got "
                             f"{self.quorum}")
        if self.elect_by not in ELECTION_CRITERIA:
            raise ValueError(f"federation elect_by must be one of "
                             f"{ELECTION_CRITERIA}, got {self.elect_by!r}")


@dataclasses.dataclass(frozen=True)
class RegionFedState:
    """One region's view at a merge boundary, as the engine emits it."""
    index: int
    name: str
    wall_clock: float       # region clock after its last completed round
    data_mass: float        # total samples held (offloading conserves it)
    model_bits: float       # payload of one model over the ISLs
    z_isl: float            # nominal ISL rate (bits/s)
    isl_scale: float = 1.0  # realized ISL rate multiplier (<1: outage/fade)
    rounds_done: int = 0

    @property
    def isl_up(self) -> bool:
        """True when the region's ISL ran clean in its last round."""
        return self.isl_scale >= 1.0


@dataclasses.dataclass(frozen=True)
class FederationState:
    """Everything a policy may consult to plan one merge.

    ``trigger`` is the region index whose boundary fired planning for
    asynchronous policies; ``None`` means a full barrier (every region
    arrived).  The live ISL adjacency derives from the per-region
    outage state ``sim.dynamics`` realized in each region's last round.
    """
    config: FederationConfig
    regions: Tuple[RegionFedState, ...]
    barrier_round: int
    trigger: Optional[int] = None

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    def live_regions(self) -> List[int]:
        """Indices of regions whose ISL is currently clean."""
        return [r.index for r in self.regions if r.isl_up]

    def isl_adjacency(self) -> np.ndarray:
        """Live ISL adjacency: ``A[i, j]`` is True when regions ``i`` and
        ``j`` can exchange models this instant (both endpoints' serving
        satellites have functional ISLs)."""
        up = np.array([r.isl_up for r in self.regions], dtype=bool)
        adj = np.logical_and.outer(up, up)
        np.fill_diagonal(adj, False)
        return adj


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """A policy's decision for one merge; the engine just executes it.

    ``weights``/``staleness`` align with ``participants`` (weights sum
    to 1); ``isl_costs`` aligns with ``recipients`` — a recipient's
    clock advances to ``time + cost`` when the merged model installs.
    """
    policy: str
    time: float                      # merge instant on the global clock
    hub: int                         # aggregating region (its satellite)
    participants: Tuple[int, ...]    # regions whose models enter the merge
    weights: Tuple[float, ...]       # normalized, aligned w/ participants
    staleness: Tuple[float, ...]     # model age (s), aligned w/ participants
    recipients: Tuple[int, ...]      # regions that install the merged model
    isl_costs: Tuple[float, ...]     # ISL price (s), aligned w/ recipients


class MergePolicy:
    """Base policy: subclasses decide ``plan``; ``apply`` is shared.

    ``requires_barrier=True`` policies are planned once every region has
    parked at the boundary (synchronous rendezvous); ``False`` policies
    are planned per region, the moment it crosses its own boundary
    (``state.trigger`` names it), with no parking.
    """
    name: str = ""
    requires_barrier: bool = True

    def __init__(self, config: FederationConfig):
        self.config = config

    def plan(self, state: FederationState) -> Optional[MergePlan]:
        """Decide one merge; ``None`` skips it (no models move)."""
        raise NotImplementedError

    def apply(self, models: Sequence, plan: MergePlan):
        """Aggregate the participants' models per the plan's weights.

        Rides ``fl.aggregation.fedavg_pytrees`` — the same stacked
        device-side dispatch ``staleness_weighted_merge`` uses (the
        Hopper ``fedavg_agg`` kernel on the card, one launch a merge),
        so policy merges and the legacy merge path stay bit-identical
        by construction.  A
        single-participant merge is the identity.
        """
        if len(models) != len(plan.participants):
            raise ValueError(f"{len(models)} models for "
                             f"{len(plan.participants)} participants")
        from ..aggregation import fedavg_pytrees
        return fedavg_pytrees(list(models), plan.weights)


# ---------------------------------------------------------------------------
# Registry -------------------------------------------------------------------
# ---------------------------------------------------------------------------
POLICIES: Dict[str, Type[MergePolicy]] = {}


def register_policy(cls: Type[MergePolicy]) -> Type[MergePolicy]:
    """Class decorator: register a policy under its ``name``."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a non-empty name")
    if cls.name in POLICIES:
        raise ValueError(f"federation policy {cls.name!r} already "
                         f"registered")
    POLICIES[cls.name] = cls
    return cls


def get_policy(config: FederationConfig) -> MergePolicy:
    """Instantiate the policy ``config.policy`` names."""
    try:
        cls = POLICIES[config.policy]
    except KeyError:
        raise ValueError(f"unknown federation policy {config.policy!r}; "
                         f"available: {list_policies()}") from None
    return cls(config)


def list_policies() -> List[str]:
    return sorted(POLICIES)


def resolve_federation(fl_federation,
                       scenario: Optional["Scenario"]
                       ) -> Optional[FederationConfig]:
    """Resolution order for the engine: ``FLConfig.federation`` wins over
    ``Scenario.federation`` (itself synthesized from the deprecated
    ``merge_*`` fields when legacy scenarios are in play).

    A bare policy-name string in ``FLConfig.federation`` keeps the
    scenario's cadence/topology/half-life and swaps only the policy; it
    is an error when no cadence is configured anywhere (a named policy
    that would silently never merge), so pass a full
    ``FederationConfig(policy=..., every=N)`` in that case.
    """
    base = scenario.resolved_federation() if scenario is not None else None
    if fl_federation is None:
        return base
    if isinstance(fl_federation, str):
        resolved = dataclasses.replace(base or FederationConfig(),
                                       policy=fl_federation)
        if resolved.every is None:
            raise ValueError(
                f"FLConfig.federation={fl_federation!r} names a policy "
                f"but no merge cadence is configured (the scenario has "
                f"no federation cadence); pass FederationConfig(policy="
                f"{fl_federation!r}, every=N) instead")
        return resolved
    if not isinstance(fl_federation, FederationConfig):
        raise TypeError(f"FLConfig.federation must be a FederationConfig, "
                        f"a policy name, or None; got "
                        f"{type(fl_federation).__name__}")
    return fl_federation
