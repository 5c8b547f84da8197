"""``repro_torch.resilience`` — deterministic fault injection + recovery.

The injection harness (:class:`FaultPlan`, :class:`FaultInjector`) lives
here; the recovery behaviors live in the hot paths they protect:
unplanned-handover re-planning in ``repro_torch.core.handover``, the
partition-tolerant merge fallback in ``repro_torch.fl.federation.policies``,
the non-finite-update quarantine in ``repro_torch.fl.rounds`` /
``repro_torch.fl.cohort_engine`` (engine checkpoint/resume waits for
the checkpoint slice, ROADMAP).  The ``chaos`` scenario preset
(``repro_torch.scenarios``) wires all of them into one run.
"""
from .faults import (DEFAULT_SEVERITY, FAULT_KINDS, FaultInjector,  # noqa: F401
                     FaultPlan, FaultSpec)

__all__ = ["DEFAULT_SEVERITY", "FAULT_KINDS", "FaultInjector", "FaultPlan",
           "FaultSpec"]
