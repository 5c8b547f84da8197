"""CLI: ``python -m repro_torch.obs report TRACE.jsonl [--top K] [--json]``.

Subcommands
-----------
``report``    per-region round tables, latency breakdown, top-k
              anomalies (see :mod:`repro_torch.obs.report`).
``perfetto``  convert a JSONL trace to Chrome-trace/Perfetto JSON
              (``--out`` overrides the default sibling path).

Exit codes: **0** report produced; **1** trace loaded but empty
(nothing to report — usually an obs-disabled run); **2** usage error
or unreadable/corrupt trace file.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .report import analyze, render
from .tracer import load_jsonl, perfetto_path, to_perfetto


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect repro-trace/1 JSONL traces")
    sub = parser.add_subparsers(dest="cmd")

    p_rep = sub.add_parser("report", help="summarize a trace")
    p_rep.add_argument("trace", help="JSONL trace path")
    p_rep.add_argument("--top", type=int, default=5,
                       help="max anomalies to list (default 5)")
    p_rep.add_argument("--json", action="store_true",
                       help="emit the report as JSON instead of tables")

    p_pf = sub.add_parser("perfetto", help="convert JSONL -> Perfetto JSON")
    p_pf.add_argument("trace", help="JSONL trace path")
    p_pf.add_argument("--out", default=None,
                      help="output path (default: <trace>.perfetto.json)")

    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        # argparse exits 2 on usage errors and 0 on --help; preserve both
        return int(e.code or 0)
    if args.cmd is None:
        parser.print_usage(sys.stderr)
        return 2

    try:
        spans = load_jsonl(args.trace)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: cannot load trace {args.trace!r}: {e}",
              file=sys.stderr)
        return 2

    if args.cmd == "perfetto":
        out = args.out or perfetto_path(args.trace)
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(to_perfetto(spans), fh)
        print(f"wrote {out} ({len(spans)} spans)")
        return 0

    if not spans:
        print("trace is empty (was the run observability-disabled?)",
              file=sys.stderr)
        return 1
    report = analyze(spans, top=args.top)
    if args.json:
        doc = {
            "n_spans": report.n_spans, "kinds": report.kinds,
            "merges": report.merges,
            "regions": [vars(r) for r in report.regions],
            "anomalies": [vars(a) for a in report.anomalies],
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
