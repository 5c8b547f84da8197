"""Deterministic, seeded fault injection for the SAGIN FL stack.

The paper's claim — adaptive offloading + seamless handover keep FL
training on track under inconsistent coverage — is only testable if
failures can be *injected* deterministically and the recovery paths
exercised on demand.  This module is the injection half; the recovery
behaviors live in the hot paths they protect
(``core.handover.replan_after_loss``,
``fl.federation.policies.plan_under_partition``, the quarantine path in
``fl.rounds``/``fl.cohort_engine``).

Typed faults (:data:`FAULT_KINDS`):

=================  =========================================================
``sat_loss``       The serving satellite dies mid-coverage at fraction
                   ``severity`` of the round's space schedule; recovery
                   re-plans an unplanned handover to the successor
                   satellite (``core.handover.replan_after_loss``).
``isl_partition``  The region's ISL is partitioned at the merge boundary
                   ``round``; recovery retries with capped backoff then
                   falls back to the ``partial``-quorum plan.
``straggler``      The round's realized latency stretches by factor
                   ``severity`` (slow node / congested uplink); absorbed
                   by the event-stepped clock.
``nan_update``     The first ``int(severity)`` trained client models of
                   the round are replaced with NaNs *after* training
                   (RNG streams untouched); recovery quarantines
                   non-finite deltas before aggregation and renormalizes
                   the eq.-(13) weights.
``trainer_crash``  The region's trainer dies for the round: no node
                   trains, the model warm-restarts unchanged next round,
                   and the clock pays ``severity`` x the round latency
                   as restart penalty.
=================  =========================================================

A :class:`FaultPlan` is an immutable schedule of :class:`FaultSpec`
entries addressed by ``(round, region)``; handcraft one (the ``chaos``
scenario preset does) or draw one from seeded per-round Bernoulli rates
with :meth:`FaultPlan.generate` — identical seeds give identical plans.
The shared :class:`FaultInjector` holds the run's injected/recovered
counters (checkpointable via ``state_dict``) and emits ``fault`` /
``recovery`` spans through ``repro_torch.obs``.

Determinism contract: injection never draws from any run RNG stream —
plans are fixed before the run starts, and corruption applies to
already-computed models — so a faulted run and a clean run share every
draw up to the first behavioral divergence the fault itself causes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

FAULT_KINDS = ("sat_loss", "isl_partition", "straggler", "nan_update",
               "trainer_crash")

#: Default ``severity`` per kind when :meth:`FaultPlan.generate` draws a
#: fault (see the kind table above for each kind's severity semantics).
DEFAULT_SEVERITY = {
    "sat_loss": 0.5,       # dies halfway through the space schedule
    "isl_partition": 1.0,
    "straggler": 2.5,      # 2.5x realized round latency
    "nan_update": 1.0,     # one corrupted client model
    "trainer_crash": 0.5,  # restart penalty: 0.5x the round latency
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``round`` is the per-region FL round index for in-round kinds, and
    the BARRIER round (rounds completed at the boundary) for
    ``isl_partition``.  ``severity`` semantics are per kind (see the
    module table).
    """
    kind: str
    round: int
    region: int
    severity: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.round < 0:
            raise ValueError(f"fault round must be >= 0, got {self.round}")
        if self.severity <= 0:
            raise ValueError(f"fault severity must be positive, got "
                             f"{self.severity}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable schedule of typed faults for one run."""
    faults: Tuple[FaultSpec, ...] = ()

    @classmethod
    def generate(cls, seed: int, n_rounds: int, n_regions: int,
                 rates: Dict[str, float],
                 severity: Optional[Dict[str, float]] = None) -> "FaultPlan":
        """Draw a plan from per-(round, region) Bernoulli rates.

        ``rates`` maps fault kind -> per-round-per-region probability;
        the plan's own ``default_rng(seed)`` drives every draw (one
        uniform per (kind, round, region) cell in sorted-kind order), so
        identical arguments give identical plans and the draws never
        touch any run RNG stream.
        """
        sev = dict(DEFAULT_SEVERITY)
        if severity:
            sev.update(severity)
        for kind in rates:
            if kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in rates; "
                                 f"expected one of {FAULT_KINDS}")
        rng = np.random.default_rng(seed)
        specs = []
        for kind in sorted(rates):
            p = float(rates[kind])
            u = rng.random((n_rounds, n_regions))
            for rnd, reg in np.argwhere(u < p).tolist():
                specs.append(FaultSpec(kind=kind, round=rnd, region=reg,
                                       severity=sev[kind]))
        specs.sort(key=lambda s: (s.round, s.region, s.kind))
        return cls(faults=tuple(specs))

    def at(self, round: int, region: int) -> Tuple[FaultSpec, ...]:
        """In-round faults scheduled for ``(round, region)`` —
        ``isl_partition`` is excluded (it fires at merge boundaries; see
        :meth:`partitioned_regions`)."""
        return tuple(f for f in self.faults
                     if f.round == round and f.region == region
                     and f.kind != "isl_partition")

    def partitioned_regions(self, barrier_round: int) -> Tuple[int, ...]:
        """Regions whose ISL is partitioned at this merge boundary."""
        return tuple(sorted({f.region for f in self.faults
                             if f.kind == "isl_partition"
                             and f.round == barrier_round}))

    def __len__(self) -> int:
        return len(self.faults)


class FaultInjector:
    """Run-wide fault bookkeeping: the one shared instance the engine
    hands to every region trainer.

    Carries the plan, the injected/recovered counters per kind (the
    numbers the trace report surfaces), and the run's
    tracer for ``fault``/``recovery`` span emission.  Counter state is
    checkpointable (:meth:`state_dict`) so a resumed run keeps counting
    where it left off.
    """

    def __init__(self, plan: FaultPlan, tracer=None):
        from ..obs import NULL_TRACER
        self.plan = plan
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.injected = {k: 0 for k in FAULT_KINDS}
        self.recovered = {k: 0 for k in FAULT_KINDS}

    # -- schedule queries ----------------------------------------------------
    def at(self, round: int, region: int) -> Tuple[FaultSpec, ...]:
        return self.plan.at(round, region)

    def partition_at(self, barrier_round: int) -> Tuple[int, ...]:
        return self.plan.partitioned_regions(barrier_round)

    # -- recording -----------------------------------------------------------
    def record_injected(self, kind: str, **attrs) -> None:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.injected[kind] += 1
        tr = self.tracer
        if tr.enabled:
            tr.event("fault", kind, fault=kind, **attrs)
            tr.metrics.counter(f"fault.injected.{kind}").inc()

    def record_recovered(self, kind: str, **attrs) -> None:
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.recovered[kind] += 1
        tr = self.tracer
        if tr.enabled:
            tr.event("recovery", kind, fault=kind, **attrs)
            tr.metrics.counter(f"fault.recovered.{kind}").inc()

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"injected": dict(self.injected),
                "recovered": dict(self.recovered)}

    def load_state_dict(self, state: dict) -> None:
        for k in FAULT_KINDS:
            self.injected[k] = int(state["injected"].get(k, 0))
            self.recovered[k] = int(state["recovered"].get(k, 0))
