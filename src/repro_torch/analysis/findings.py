"""Finding records, severities, output formats, and the baseline file.

A :class:`Finding` is one rule violation at one source location.  The
baseline file is the suppression mechanism for *accepted* findings
(ruff's ``--add-noqa`` equivalent, kept out-of-band so the source stays
clean): a JSON list of ``path:rule:line`` keys.  ``python -m
repro.analysis --write-baseline`` regenerates it; the CI lane loads the
committed one, so only findings introduced after the baseline was
written can fail the lane.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

ERROR = "error"
WARNING = "warning"
SEVERITIES = (ERROR, WARNING)

BASELINE_VERSION = 1
DEFAULT_BASELINE = ".repro-analysis-baseline.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    severity: str            # "error" | "warning"
    path: str                # posix-style, relative to the invocation root
    line: int                # 1-based
    col: int                 # 0-based (ast convention)
    message: str

    @property
    def key(self) -> str:
        """Baseline identity: location + rule (message text may evolve)."""
        return f"{self.path}:{self.rule}:{self.line}"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def format_text(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule} [{self.severity}] {self.message}")


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def render_text(findings: Sequence[Finding]) -> str:
    lines = [f.format_text() for f in sort_findings(findings)]
    n_err = sum(1 for f in findings if f.severity == ERROR)
    n_warn = len(findings) - n_err
    lines.append(f"{len(findings)} finding(s): {n_err} error(s), "
                 f"{n_warn} warning(s)")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    return json.dumps(
        {"version": BASELINE_VERSION,
         "findings": [f.to_dict() for f in sort_findings(findings)]},
        indent=2) + "\n"


# ---------------------------------------------------------------------------
# Baseline I/O
# ---------------------------------------------------------------------------
def load_baseline(path: Path) -> Set[str]:
    """Read the accepted-finding keys from a baseline file."""
    data = json.loads(Path(path).read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version "
                         f"{data.get('version')!r} in {path}")
    return set(data["suppressed"])


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    """Accept every current finding: subsequent runs with this baseline
    report only NEW findings."""
    data = {
        "version": BASELINE_VERSION,
        "tool": "repro.analysis",
        "suppressed": sorted({f.key for f in findings}),
    }
    Path(path).write_text(json.dumps(data, indent=2) + "\n")


def apply_baseline(findings: Sequence[Finding],
                   suppressed: Optional[Set[str]]) -> List[Finding]:
    """Drop findings whose key the baseline accepts."""
    if not suppressed:
        return list(findings)
    return [f for f in findings if f.key not in suppressed]
