"""Static analysis + runtime contracts for the repro codebase.

Two halves, one invariant set:

* :mod:`repro_torch.analysis.rules` /
  :mod:`repro_torch.analysis.engine` — an AST-based linter
  (``python -m repro_torch.analysis``) catching RNG indiscipline,
  recompile hazards, donation bugs, and host-sync smells *before* they
  run; a copy of the reference's, with the same rules and findings.
* :mod:`repro_torch.analysis.contracts` — runtime context managers
  (``no_recompile``, ``assert_donated``, ``nan_tripwire``) asserting
  the same invariants *while* they run, in PyTorch's terms, used by
  ``CohortEngine`` and the test suite.
"""
from .engine import classify, discover, scan
from .findings import (DEFAULT_BASELINE, ERROR, WARNING, Finding,
                       apply_baseline, load_baseline, render_json,
                       render_text, sort_findings, write_baseline)
from .rules import RULES, Rule

__all__ = [
    "classify", "discover", "scan",
    "DEFAULT_BASELINE", "ERROR", "WARNING", "Finding",
    "apply_baseline", "load_baseline", "render_json", "render_text",
    "sort_findings", "write_baseline",
    "RULES", "Rule",
]
