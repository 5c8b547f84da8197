"""The program's tracer in the SAGIN cell, in one process on the card.

1. cost: windows of the cell's rounds with the tracer off, on without
   fences, on with ``device_timing``, interleaved, ``--reps`` of each;
2. inside vs outside: in the fenced windows, each ``round`` span's wall
   against the benchmark's clock around the step, and the phase readers'
   sum against ``control_ms.sagin``;
3. clock: one unfenced round under ``torch.profiler`` (host operators
   and the card), the ``h2d`` spans mapped with ``Tracer.unix_ns`` onto
   the profile's ``cudaMemcpyAsync`` runtime events, and a
   ``record_function`` opened inside a phase;
4. emission: the host microseconds one ``phase`` span costs (enter, exit,
   record), and the spans a traced round records.

    python3 perfbench/tracing_cost.py [--seconds 20] [--reps 3] \
        [--out FILE]

One JSON document (also written to ``--out``): ``round_s`` by mode, each
fenced window's ``inside_outside``, and ``clock``.  As in ``run.py``,
the cell's cache directories and host threads are set before torch is
imported.  The benchmark's runs never run this.
"""
import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench.lib import harness  # noqa: E402
from perfbench.lib import profile as P  # noqa: E402

CELL = "sagin_round.vgg11.adaptive"
READERS = ("control_ms.sagin", "local_update_ms.sagin", "plan_ms.sagin",
           "offload_opt_ms.sagin", "gather_ms.sagin", "h2d_gib_s.sagin",
           "aggregate_ms.sagin", "eval_ms.sagin", "round_self_ms.sagin")


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "probe_" + name)


def inside_outside(drv, st, win):
    data = drv.layer_data(st, win, {"rounds": []})
    vals = {n: reader(n).read(data) for n in READERS}
    spans = data["spans"]
    walls = {s["round"]: s["dur_wall"] for s in spans
             if s["kind"] == "round"}
    rel = [walls[r["round"]] / (r["t1"] - r["t0"]) - 1.0
           for r in win["rounds"]]
    n = len(win["rounds"])
    extra = {}
    for ph in ("pools", "losses"):
        extra[ph + "_ms"] = 1000.0 * sum(
            s["dur_wall"] for s in spans
            if s["kind"] == "phase" and s["name"] == ph) / n
    parts = (vals["plan_ms.sagin"] + vals["gather_ms.sagin"]
             + vals["aggregate_ms.sagin"] + vals["eval_ms.sagin"]
             + vals["round_self_ms.sagin"] + extra["pools_ms"]
             + extra["losses_ms"])
    round_ms = 1000.0 * sum(walls[r["round"]] for r in win["rounds"]) / n
    return {"metrics": vals, **extra, "rounds": n,
            "round_span_vs_clock_rel": [min(rel), max(rel)],
            "parts_sum_ms": parts,
            "parts_vs_control_rel": parts / vals["control_ms.sagin"] - 1.0,
            "round_self_share": vals["round_self_ms.sagin"] / round_ms}


def clock(drv, st, tr, device):
    import torch
    tr.enabled, tr.device_timing = True, False
    r0 = st.next_round
    offsets = []
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        drv.window(st, 0.0, False, rounds=1)
        for k in range(5):
            with tr.phase("clock_probe") as ph:
                with torch.profiler.record_function(f"clock_probe{k}"):
                    ph.set(k=k)
        if device == "cuda":
            torch.cuda.synchronize()
    dev, host = P.raw_events(prof)
    starts = {n: t0 for t0, _, n in host if n.startswith("clock_probe")}
    for s in tr.spans:
        if s.name == "clock_probe":
            offsets.append(starts[f"clock_probe{s.attrs['k']}"]
                           - tr.unix_ns(s.t_wall))
    memcpy = sorted((t0, t1) for t0, t1, n in host
                    if n == "cudaMemcpyAsync")
    htod = sorted((t0, t1) for t0, t1, n in dev if "HtoD" in n)
    h2d = [s for s in tr.spans if s.round == r0 and s.name == "h2d"]
    owners = [s for s in tr.spans if s.round == r0
              and s.kind in ("phase", "bucket_dispatch")
              and s.name != "clock_probe"]
    rows, inside = [], 0
    for s in h2d:
        a = tr.unix_ns(s.t_wall)
        b = tr.unix_ns(s.t_wall + s.dur_wall)
        mine = [m for m in memcpy if a <= m[0] and m[1] <= b]
        devs = [d for d in htod if a <= d[0] and d[1] <= b]
        inside += len(mine)
        rows.append({"bucket": s.attrs["parent"], "bytes": s.attrs["bytes"],
                     "span_us": (b - a) / 1e3, "memcpy_calls": len(mine),
                     "htod_copies": len(devs),
                     "lead_us": (mine[0][0] - a) / 1e3 if mine else None,
                     "tail_us": (b - mine[-1][1]) / 1e3 if mine else None})
    where = {}
    for m in memcpy:
        inner = [p for p in owners
                 if tr.unix_ns(p.t_wall) <= m[0]
                 and m[1] <= tr.unix_ns(p.t_wall + p.dur_wall)]
        key = "none"
        if inner:
            p = min(inner, key=lambda p: p.dur_wall)
            key = p.name if p.kind == "phase" else p.kind
        where[key] = where.get(key, 0) + 1
    return {"round": r0, "record_function_minus_span_start_us":
            [o / 1e3 for o in offsets],
            "h2d_spans": rows, "memcpy_calls_in_round": len(memcpy),
            "memcpy_calls_inside_h2d": inside,
            "memcpy_calls_by_innermost_phase": where}


def emission(tr, n=20000):
    """Host us a ``phase`` span costs, and the spans of the last round."""
    tr.enabled, tr.device_timing = True, False
    before = len(tr.spans)
    t0 = time.perf_counter()
    for _ in range(n):
        with tr.phase("emission_probe") as ph:
            ph.set(bytes=1)
    us = (time.perf_counter() - t0) / n * 1e6
    del tr.spans[before:]
    last = max(s.round for s in tr.spans)
    return {"phase_us": us,
            "spans_a_round": sum(1 for s in tr.spans if s.round == last)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=3000002001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    t_start = time.perf_counter()
    harness.cache_dirs()
    ctx = harness.context(CELL, args.seed)
    harness.host_threads(ctx)
    import torch
    device = torch.device(ctx.device).type
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    drv = harness.driver(ctx)
    st = drv.build(ctx, True)
    drv.first_steps(st)
    drv.warm(st)
    sync()
    tr = st.trainer.tracer
    out = {"card": harness.card(torch), "torch": torch.__version__,
           "threads": {"torch": torch.get_num_threads(),
                       **{v: os.environ.get(v)
                          for v in harness.THREAD_VARS}},
           "setup_s": time.perf_counter() - t_start, "seed": args.seed}
    modes = [("off", False, False), ("on", True, False),
             ("on_fenced", True, True)]
    cost = {m[0]: [] for m in modes}
    checks = []
    for rep in range(args.reps):
        for name, enabled, fenced in modes[rep % 3:] + modes[:rep % 3]:
            tr.enabled = enabled
            tr.device_timing = fenced
            win = drv.window(st, args.seconds, fenced)
            sync()
            cost[name].append(win["wall_s"] / len(win["rounds"]))
            line = {"rep": rep, "mode": name, "round_s": cost[name][-1]}
            if fenced:
                checks.append(inside_outside(drv, st, win))
                line["inside_outside"] = checks[-1]
            print(json.dumps(line), flush=True)
    out["round_s"] = cost
    med = {k: statistics.median(v) for k, v in cost.items()}
    out["round_s_median"] = med
    out["cost_rel"] = {k: med[k] / med["off"] - 1.0 for k in med}
    out["inside_outside"] = checks
    out["emission"] = emission(tr)
    print(json.dumps({"emission": out["emission"]}), flush=True)
    out["clock"] = clock(drv, st, tr, device)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
