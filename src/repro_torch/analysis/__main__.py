"""CLI: ``python -m repro_torch.analysis [paths] --format text|json ...``

Exit codes: 0 clean (or only baselined / warning-severity findings),
1 unsuppressed error-severity findings (``--strict`` promotes warnings),
2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .engine import scan
from .findings import (DEFAULT_BASELINE, ERROR, Finding, apply_baseline,
                       load_baseline, render_json, render_text,
                       write_baseline)
from .rules import RULES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="JAX-aware static analysis: RNG discipline, recompile "
                    "hazards, donation safety, host-sync smells.")
    p.add_argument("paths", nargs="*", default=["src"],
                   help="files or directories to scan (default: src)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", metavar="FILE", default=None,
                   help=f"baseline of accepted findings (default: "
                        f"{DEFAULT_BASELINE} if present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", metavar="FILE", nargs="?",
                   const=DEFAULT_BASELINE, default=None,
                   help="accept all current findings into FILE and exit 0")
    p.add_argument("--select", metavar="RULES", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on warnings too, not just errors")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{r.id}  {r.severity:7s}  {r.name}: {r.summary} "
                  f"(applies to: {', '.join(r.kinds)})")
        return 0

    if args.select:
        unknown = [r for r in args.select.split(",") if r not in RULES]
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
        rule_ids = args.select.split(",")
    else:
        rule_ids = None

    for path in args.paths:
        if not Path(path).exists():
            print(f"no such path: {path}", file=sys.stderr)
            return 2

    findings = scan(args.paths, rule_ids=rule_ids)

    if args.write_baseline is not None:
        write_baseline(Path(args.write_baseline), findings)
        print(f"wrote {len(findings)} accepted finding(s) to "
              f"{args.write_baseline}")
        return 0

    if not args.no_baseline:
        baseline_path = args.baseline or (
            DEFAULT_BASELINE if Path(DEFAULT_BASELINE).exists() else None)
        if baseline_path is not None:
            try:
                suppressed = load_baseline(Path(baseline_path))
            except (OSError, ValueError, KeyError) as e:
                print(f"bad baseline {baseline_path}: {e}", file=sys.stderr)
                return 2
            findings = apply_baseline(findings, suppressed)

    out = (render_json(findings) if args.format == "json"
           else render_text(findings))
    print(out, end="" if out.endswith("\n") else "\n")

    def fails(f: Finding) -> bool:
        return f.severity == ERROR or args.strict
    return 1 if any(fails(f) for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
