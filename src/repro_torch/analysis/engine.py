"""File discovery, file-kind classification, and the two-pass scan.

Pass 1 parses every file and collects project-wide *donating callables*
(``jax.jit(..., donate_argnums=...)`` bindings), so DON001 can flag a
use-after-donate even when the donating function is imported from a
sibling module (the repo's real layout: ``cohort_round_step_donated``
lives in ``fl/client.py`` and is consumed by ``fl/cohort_engine.py``).
Pass 2 runs every registered rule whose ``kinds`` include the file's
kind.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import ERROR, Finding, sort_findings
from .rules import (BENCH, EXAMPLE, LIBRARY, RULES, TEST, FileContext,
                    build_import_table, collect_donors)

_SKIP_DIRS = {".git", "__pycache__", ".venv", "venv", "build", "dist",
              ".eggs", "node_modules"}


def classify(path: Path) -> str:
    """File kind from its path: test / example / bench / library."""
    parts = [p.lower() for p in path.parts]
    name = path.name.lower()
    if ("tests" in parts or name.startswith("test_")
            or name.startswith("conftest")):
        return TEST
    if "examples" in parts or "docs" in parts:
        return EXAMPLE
    if "benchmarks" in parts or "bench" in parts:
        return BENCH
    return LIBRARY


def discover(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS for part in f.parts):
                    files.append(f)
        elif p.suffix == ".py":
            files.append(p)
    # stable order, no duplicates
    seen, out = set(), []
    for f in files:
        key = f.resolve()
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _display(path: Path, root: Optional[Path]) -> str:
    try:
        rel = path.resolve().relative_to((root or Path.cwd()).resolve())
        return rel.as_posix()
    except ValueError:
        return path.as_posix()


def _parse(path: Path) -> Tuple[Optional[ast.Module], Optional[str]]:
    try:
        return ast.parse(path.read_text(encoding="utf-8")), None
    except SyntaxError as e:
        return None, f"syntax error: {e.msg} (line {e.lineno})"
    except (OSError, UnicodeDecodeError) as e:
        return None, f"unreadable: {e}"


def scan(paths: Sequence[Path], root: Optional[Path] = None,
         rule_ids: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the lint rules over ``paths`` (files or directories)."""
    files = discover([Path(p) for p in paths])
    parsed: List[Tuple[Path, str, ast.Module, Dict[str, str]]] = []
    findings: List[Finding] = []

    # pass 1: parse + project-wide donor table
    donors: Dict[str, Tuple[int, ...]] = {}
    for f in files:
        tree, err = _parse(f)
        display = _display(f, root)
        if tree is None:
            findings.append(Finding(rule="PARSE", severity=ERROR,
                                    path=display, line=1, col=0,
                                    message=err or "unparseable"))
            continue
        imports = build_import_table(tree)
        donors.update(collect_donors(tree, imports))
        parsed.append((f, display, tree, imports))

    # pass 2: rules
    active = [RULES[r] for r in (rule_ids or sorted(RULES))]
    for f, display, tree, imports in parsed:
        ctx = FileContext(path=display, kind=classify(f), tree=tree,
                          imports=imports, donors=donors)
        for rule in active:
            if ctx.kind not in rule.kinds:
                continue
            for node, message in rule.check(ctx):
                findings.append(Finding(
                    rule=rule.id, severity=rule.severity, path=display,
                    line=getattr(node, "lineno", 1),
                    col=getattr(node, "col_offset", 0), message=message))
    return sort_findings(findings)
