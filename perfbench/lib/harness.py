"""One run of one cell: set-up, the measured window, the reference check,
the result line.

Everything a cell needs is found by name.  ``BENCHMARK.json`` names the
cell and its configuration; ``perfbench/workloads/<cell>.json`` names the
driver and holds the traffic and the comparison's limits;
``perfbench/configs/<config>.json`` holds the sizes;
``perfbench/drivers/<driver>.py`` sets the program up, runs the window and
the reference; ``perfbench/metrics/<metric>.py`` reads one per-layer
metric from the traced run.  Adding a cell, a configuration or a metric
adds files and entries, and edits none.

A driver module provides::

    build(ctx, traced) -> state      the program, made from ctx.seed
                                     (traced: its own tracer on)
    first_steps(state)               the compared steps, through the
                                     window's own call and feed
    warm(state)                      the rest of the warm-up
    window(state, seconds, traced, rounds=None) -> win
                                     (``rounds``: that many, whatever
                                     the seconds; ``traced``: the
                                     program's spans fenced and kept;
                                     the profiled rounds run untraced)
    end_to_end(state, win) -> {metric: value}
    layer_data(state, win, profiled) -> dict
                                     what the per-layer readers read:
                                     the window's rounds and wall, and
                                     the profiled segment's rounds
    release(state)                   frees the program's state
    program_readings(state) -> dict  the program's side of the comparison
    reference(ctx) -> dict           the plain reference's side
    judge(prog, ref) -> {number: value}
    control(ctx) -> dict             the control's side: the program's own
                                     lower precision, or the reference
                                     in it, in the program's place
    notes(state, win) -> [str]       lines printed before the result

and ``win`` holds ``attempted`` and ``failed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    name: str
    workload: dict          # perfbench/workloads/<name>.json
    cell: dict              # the cell's entry in BENCHMARK.json
    config: dict            # perfbench/configs/<config>.json
    seed: int
    device: str = "cuda"

    def log(self, msg: str) -> None:
        print(f"[perfbench {self.name}] {msg}", file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def context(name: str, seed: int, device: str = "cuda",
            bench: Optional[dict] = None) -> Context:
    """The cell ``name`` as the files describe it."""
    bench = bench or benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    if workload["config"] != cell["config"]:
        raise SystemExit(f"{name}: the workload file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{cell['config']!r}")
    return Context(name, workload, cell, config, seed, device)


def driver(ctx: Context):
    return load_module(BENCH / "drivers" / f"{ctx.workload['driver']}.py",
                       f"perfbench_driver_{ctx.workload['driver']}")


def applies(metric: dict, cell: str, reported=()) -> bool:
    """Whether ``metric`` is this cell's: it lists the cell, or lists no
    cells and moves (or is) a metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported or \
        "moves" not in metric


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernels build under ``build/`` there already)."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = base / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def host_threads(ctx: Context) -> Optional[int]:
    """The host threads of the cell's workload file (``host_threads``):
    the CPU pools of torch and of NumPy's BLAS at that size, set before
    either is imported, so that a host whose cores are shared does not
    stall a round on a pool's barrier or spinning workers."""
    n = ctx.workload.get("host_threads")
    if n:
        for var in THREAD_VARS:
            os.environ[var] = str(int(n))
    return n


def card(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    limit = "unknown"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        limit = out.stdout.strip().splitlines()[0] if out.stdout else limit
    except (OSError, subprocess.SubprocessError):
        pass
    return {"kind": name, "power": limit}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(ctx: Context, seconds: float, traced: bool, t_start: float,
        chips: int = 1) -> dict:
    """One run of the cell: returns the result line's object (and the
    checks, printed by :func:`main`)."""
    import torch
    from . import profile as P

    cuda = torch.device(ctx.device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    peak = torch.cuda.max_memory_allocated if cuda else (lambda: 0)
    drv = driver(ctx)
    ctx.log(f"set-up (seed {ctx.seed})")
    state = drv.build(ctx, traced)
    drv.first_steps(state)
    drv.warm(state)
    sync()
    setup_peak = peak()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    ctx.log(f"set-up {setup_s:.3f} s; window {seconds} s "
            f"{'traced' if traced else 'untraced'}")
    win = drv.window(state, seconds, traced)
    sync()
    window_peak = peak()
    prof_rounds = None
    if traced:
        # the profiled segment: a few more rounds under the profiler,
        # after the window, so that its overhead stays out of the window
        with P.capture(True) as prof:
            with torch.profiler.record_function(P.WINDOW):
                prof_rounds = drv.window(state, 0.0, False,
                                         rounds=ctx.workload[
                                             "profiled_rounds"])
            sync()
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: "
                         f"{found}")
    e2e = drv.end_to_end(state, win)
    e2e["peak_mem_gib"] = window_peak / 2 ** 30
    e2e["setup_s"] = setup_s
    bench = benchmark()
    reported = [m["name"] for m in bench["end_to_end"]
                if applies(m, ctx.name)]
    notes = drv.notes(state, win)
    if prof_rounds is not None:
        notes.append("profiled rounds, walls s: " + str(
            [round(r["t1"] - r["t0"], 4) for r in prof_rounds["rounds"]]))
    metrics: Dict[str, dict] = {}
    breakdown = None
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": chips,
              "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if traced:
        red = P.reduce(prof)
        del prof
        data = drv.layer_data(state, win, prof_rounds)
        data.update(profile=red, config=ctx.config, workload=ctx.workload)
        for m in bench["per_layer"]:
            if not applies(m, ctx.name, reported):
                continue
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 f"perfbench_metric_{m['name']}")
            value = reader.read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = red["breakdown"]
    else:
        for m in bench["end_to_end"]:
            if applies(m, ctx.name):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    prog = drv.program_readings(state)
    drv.release(state)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx.log("reference")
    ref = drv.reference(ctx)
    numbers = drv.judge(prog, ref)
    limits = ctx.workload["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    if cuda:
        notes.append(f"card: {card(torch)}")
    notes.append(f"host threads: torch {torch.get_num_threads()}, "
                 + ", ".join(f"{v}={os.environ.get(v)}" for v in THREAD_VARS))
    notes.append("readings: " + json.dumps(numbers))
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return {"line": out, "notes": notes}


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    ctx = context(args.workload, args.seed)
    host_threads(ctx)
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import torch
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}: no run",
              file=sys.stderr)
        return 3
    res = run(ctx, args.seconds, bool(args.trace), t_start, chips)
    for line in res["notes"]:
        print(line, flush=True)
    for k, c in res["line"]["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res["line"]), flush=True)
    return 0
