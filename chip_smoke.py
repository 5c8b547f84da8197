#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

1. ``card``: the card's name and power limit (nvidia-smi), the CUDA
   version, and the build of every hand-written kernel from the sources
   in this checkout (one nvcc per source, all started together).
2. ``main_path``: the port's FL round loop at the paper's default setup
   (``run_fl(FLConfig(n_rounds=3))``: MNIST CNN, 50 devices, 5 air
   nodes, H=5, batched on the card), with every kernel's launch count
   set to 0 just before and read just after.
3. ``round_profile``: one steady round of that setup under
   ``torch.profiler``: the card's busy share and kernel time by name.
4. ``kernel``: each kernel against its plain PyTorch version on the
   card, at the shapes the main path gave it (and at VGG-11's size), in
   float32 and bfloat16, with the error, the tolerance and CUDA-event
   times of the kernel, the plain version and one library call (on the
   card alone, from a replayed CUDA graph, and issued eagerly from
   Python), beside the least time the card could take (``bound_ms``).
5. ``card_vs_cpu``: two batched rounds of the same setup from the same
   initial params on the card and on the CPU, TF32 off for matmul and
   cuDNN, cuDNN deterministic: plan cases, latencies and wall clocks
   identical, accuracies within 4/eval_size, and params within 1e-4
   round by round (each card round from the CPU's params before it);
   beside them the free-running gap and the CPU's own spread from an
   init moved by one part in 1e7.
6. ``vgg11``: two rounds of ``dataset="cifar10"`` (VGG-11, lr 0.005),
   the largest aggregate the kernel sees.

Then a ``{"kernels": [...]}`` line and, last, the device line.  Any
failed phase, a missing CUDA device, or a directory without the rest of
the repository gives a non-zero exit and no result line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth and the peak rates of the
# operations these kernels do, by input type (float32 outside the tensor
# cores, bf16 dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-6, "bfloat16": 2e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _event_ms(run, repeats: int) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``run()``."""
    import torch
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def time_ms(fn, reps: int = 20, repeats: int = 5) -> dict:
    """Per-call times of ``fn`` from CUDA events, warmed up first.

    ``device``: ``reps`` calls captured in one CUDA graph and replayed,
    so the host's per-call cost (Python, argument checks, the launch
    itself) drops out and what is left is the card's time.  ``eager``:
    ``reps`` calls issued back to back from Python, as the round loop
    issues them; where it exceeds ``device`` the card waits on the host.
    """
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def eager():
        for _ in range(reps):
            fn()

    out = {"device": _event_ms(graph.replay, repeats) / reps,
           "eager": _event_ms(eager, repeats) / reps}
    del graph
    return out


def phase_card(kernels):
    import torch
    from repro_torch.kernels.build import compile_library
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        libs = list(pool.map(lambda k: compile_library(k.SOURCE), kernels))
    for k in kernels:
        k.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          "ptxas": {str(lib.relative_to(ROOT)):
                    [ln for ln in (lib.parent / "build.log").read_text()
                     .splitlines() if "registers" in ln or "spill" in ln]
                    for lib in libs},
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})


def phase_main_path(agg_kernel):
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.obs import ObsConfig, Tracer
    cfg = FLConfig(n_rounds=3)
    tracer = Tracer(ObsConfig(path=None))
    agg_kernel.weighted_aggregate.launches = 0
    t0 = time.perf_counter()
    res = run_fl(cfg, tracer=tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = agg_kernel.weighted_aggregate.launches
    # per-round wall seconds from the round spans' host clock (round 0
    # also holds the trainer's construction); clients aggregated per
    # round from the bucket dispatches
    round_ends = [s.t_wall for s in tracer.spans if s.kind == "round"]
    per_round = [b - a for a, b in zip([0.0] + round_ends, round_ends)]
    clients = [sum(s.attrs["clients"] for s in tracer.spans
                   if s.kind == "bucket_dispatch" and s.round == r)
               for r in range(cfg.n_rounds)]
    buckets = sorted({s.name for s in tracer.spans
                      if s.kind == "bucket_dispatch"})
    ok = (launches >= 8 * cfg.n_rounds
          and all(math.isfinite(a) for a in res.accuracies)
          and all(res.participated))
    emit({"phase": "main_path", "ok": ok, "config": "FLConfig(n_rounds=3)",
          "execution": cfg.resolved_execution(), "wall_s": wall,
          "round_wall_s": per_round, "accuracies": res.accuracies,
          "losses": res.losses, "latencies": res.latencies,
          "cases": res.cases, "buckets": buckets,
          "clients_per_round": clients, "fedavg_agg_launches": launches})
    if not ok:
        raise RuntimeError("main path: too few fedavg_agg launches or "
                           "non-finite accuracies")
    return launches, max(clients)


def phase_round_profile():
    """One steady round of the main path under ``torch.profiler``: the
    card's busy share of the round's wall time and its kernel time by
    name, with ``fedavg_agg``'s own share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl import FLConfig, RegionTrainer
    tr = RegionTrainer(FLConfig(n_rounds=2))
    tr.step(0)
    torch.cuda.synchronize()
    # device activity only, so that the host side runs at its own pace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            ms, n = by_name.get(ev.key, (0.0, 0))
            by_name[ev.key] = (ms + dev_us / 1e3, n + ev.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    agg = [(ms, n) for name, (ms, n) in by_name.items()
           if "fedavg_agg" in name]
    emit({"phase": "round_profile", "round_wall_ms": wall_ms,
          "device_busy_ms": busy_ms if by_name else "not measured",
          "device_busy_share": busy_ms / wall_ms if by_name
          else "not measured",
          "fedavg_agg_ms": sum(ms for ms, _ in agg) if agg
          else "not measured",
          "fedavg_agg_kernels": sum(n for _, n in agg),
          "top_kernels_ms": [[name[:90], ms, n] for name, (ms, n) in top]})


def _agg_case(kernel, ref, shape, dtype_name, seed):
    """One kernel-vs-plain comparison with times, on the card."""
    import torch
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = torch.rand(shape[0], generator=gen, device="cuda") + 0.1
    w = w / w.sum()
    w_lib = w.to(dtype)  # the library call takes one type throughout
    got = kernel.weighted_aggregate(x, w)
    want = ref.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = TOLERANCE[dtype_name]
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    c, p = shape[0], x.numel() // shape[0]
    nbytes = c * p * x.element_size() + 4 * c + p * x.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * c * p / PEAK_OPS_PER_S[dtype_name] * 1e3
    times = {
        "kernel": time_ms(lambda: kernel.weighted_aggregate(x, w)),
        "plain": time_ms(lambda: ref.weighted_aggregate(x, w)),
        "library": time_ms(lambda: torch.tensordot(w_lib, x, dims=1)),
    }
    return {
        "shape": list(shape), "dtype": dtype_name,
        "max_abs_err": float(diff.max()), "tolerance": tol, "ok": ok,
        **{f"{k}_ms": t["device"] for k, t in times.items()},
        **{f"{k}_eager_ms": t["eager"] for k, t in times.items()},
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes,
    }


def phase_kernel(agg_kernel, agg_ref, clients):
    import torch
    from repro_torch.models.cnn import build_model
    from repro_torch.tree import tree_leaves
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    leaf_shapes = [tuple(t.shape) for t in tree_leaves(params)]
    cases = {}
    for dtype_name in ("float32", "bfloat16"):
        for i, leaf in enumerate(leaf_shapes):
            cases[(dtype_name, "mnist", i)] = _agg_case(
                agg_kernel, agg_ref, (clients,) + leaf, dtype_name, i)
        cases[(dtype_name, "vgg11", 0)] = _agg_case(
            agg_kernel, agg_ref, (clients, 9_225_610), dtype_name, 99)
    for (dtype_name, model, _), case in cases.items():
        emit({"phase": "kernel", "kernel": "fedavg_agg", "model": model,
              **case})
    # the main path's round aggregate: every MNIST leaf, float32
    main = [v for (d, m, _), v in cases.items()
            if d == "float32" and m == "mnist"]
    summary = {key: sum(c[key] for c in main)
               for key in ("kernel_ms", "plain_ms", "library_ms",
                           "kernel_eager_ms", "plain_eager_ms",
                           "library_eager_ms", "bound_ms")}
    summary["max_abs_err"] = max(c["max_abs_err"] for c in main)
    summary["bound_by"] = ("bytes" if all(c["bound_by"] == "bytes"
                                          for c in main) else "operations")
    emit({"phase": "kernel", "kernel": "fedavg_agg",
          "model": "mnist round aggregate (all leaves, float32)",
          "clients": clients, **summary})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"fedavg_agg disagrees with its plain version: "
                           f"{bad}")
    return summary


def _steps(device, init, rounds, teacher=None):
    """Step a batched paper-setup trainer on ``device`` from ``init``.

    Returns the trainer, its params after each round (on the CPU) and
    the seconds it took.  With ``teacher`` (params before each round),
    every round starts from the teacher's params instead of its own.
    """
    import torch
    from repro_torch.fl import FLConfig, RegionTrainer
    from repro_torch.tree import tree_map
    # one execution mode on both devices, so that only the devices
    # differ ("auto" would pick sequential on the CPU)
    tr = RegionTrainer(FLConfig(n_rounds=rounds, device=device,
                                execution="batched"), params=init)
    after = []
    t0 = time.perf_counter()
    for r in range(rounds):
        if teacher is not None:
            tr.params = tree_map(lambda t: t.to(tr.device, copy=True),
                                 teacher[r])
        tr.step(r)
        after.append(tree_map(lambda t: t.detach().cpu().clone(),
                              tr.params))
    if tr.device.type == "cuda":
        torch.cuda.synchronize()
    return tr, after, time.perf_counter() - t0


def phase_card_vs_cpu(agg_kernel):
    """Two batched rounds on the card and on the CPU from one init.

    A float32 trajectory of this setup is itself sensitive: the CPU run
    from an init moved by one part in 1e7 (the size of a rounding
    difference) is reported beside the card's gap as the CPU's own
    spread.  So params are held to 1e-4 round by round, each round on
    the card starting from the CPU's params before it; the free-running
    trajectories are held to identical plan cases, latencies and wall
    clocks and to accuracies within 4/eval_size.
    """
    import torch
    from repro_torch.models.cnn import build_model
    from repro_torch.tree import tree_leaves, tree_map
    rounds = 2
    backends = torch.backends
    saved = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32,
             backends.cudnn.deterministic)
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.allow_tf32 = False
    backends.cudnn.deterministic = True
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    nudged = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
        t.shape, generator=gen)), params)
    agg_kernel.weighted_aggregate.launches = 0
    try:
        cpu, cpu_after, cpu_s = _steps("cpu", params, rounds)
        gpu, gpu_after, gpu_s = _steps("cuda", params, rounds)
        _, forced_after, _ = _steps("cuda", params, rounds,
                                    teacher=[params] + cpu_after[:-1])
        _, nudged_after, _ = _steps("cpu", nudged, rounds)
    finally:
        (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32,
         backends.cudnn.deterministic) = saved
    launches = agg_kernel.weighted_aggregate.launches

    def err(a, b):
        return max(float((x - y).abs().max())
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    g, c = gpu.result, cpu.result
    per_round = [err(a, b) for a, b in zip(forced_after, cpu_after)]
    acc_err = max(abs(a - b) for a, b in zip(g.accuracies, c.accuracies))
    ok = (g.cases == c.cases and g.latencies == c.latencies
          and g.times == c.times and max(per_round) <= 1e-4
          and acc_err <= 4 / gpu.cfg.eval_size)
    emit({"phase": "card_vs_cpu", "ok": ok, "rounds": rounds,
          "tf32": {"matmul": False, "cudnn": False},
          "cudnn_deterministic": True,
          "execution": {"cuda": gpu.execution, "cpu": cpu.execution},
          "cases_equal": g.cases == c.cases,
          "latencies_equal": g.latencies == c.latencies,
          "times_equal": g.times == c.times,
          "param_abs_err_per_round": per_round, "param_tolerance": 1e-4,
          "trajectory_param_abs_err": [err(a, b) for a, b in
                                       zip(gpu_after, cpu_after)],
          "cpu_nudged_param_abs_err": [err(a, b) for a, b in
                                       zip(nudged_after, cpu_after)],
          "max_accuracy_err": acc_err,
          "accuracy_tolerance": 4 / gpu.cfg.eval_size,
          "accuracies": {"cuda": g.accuracies, "cpu": c.accuracies},
          "wall_s": {"cuda": gpu_s, "cpu": cpu_s},
          "fedavg_agg_launches": launches})
    if not ok:
        raise RuntimeError("card and CPU runs disagree")


def phase_vgg11(agg_kernel):
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.obs import ObsConfig, Tracer
    # at the default lr=0.05 VGG-11 (no normalization layers) diverges
    # to NaN in its first round, in the reference as in the port; 0.005
    # keeps it finite, so that the output can be checked
    cfg = FLConfig(dataset="cifar10", n_rounds=2, lr=0.005)
    tracer = Tracer(ObsConfig(path=None))
    agg_kernel.weighted_aggregate.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = run_fl(cfg, tracer=tracer)
    torch.cuda.synchronize()
    launches = agg_kernel.weighted_aggregate.launches
    round_ends = [s.t_wall for s in tracer.spans if s.kind == "round"]
    per_round = [b - a for a, b in zip([0.0] + round_ends, round_ends)]
    ok = (launches >= 18 * cfg.n_rounds
          and all(math.isfinite(v) for v in res.accuracies + res.losses))
    emit({"phase": "vgg11", "ok": ok, "config": cfg.dataset, "lr": cfg.lr,
          "round_wall_s": per_round, "accuracies": res.accuracies,
          "losses": res.losses, "fedavg_agg_launches": launches,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not ok:
        raise RuntimeError("VGG-11 rounds: too few launches or non-finite "
                           "accuracies or losses")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
        from repro_torch.kernels.fedavg_agg import ref as agg_ref
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch ({exc}); run it from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    try:
        phase_card([agg_kernel])
        launches, clients = phase_main_path(agg_kernel)
        phase_round_profile()
        summary = phase_kernel(agg_kernel, agg_ref, clients)
        phase_card_vs_cpu(agg_kernel)
        phase_vgg11(agg_kernel)
    except Exception:  # report the failed phase, then fail the run
        traceback.print_exc()
        emit({"phase": "failed", "error": traceback.format_exc(limit=3)})
        return 1
    emit({"kernels": [{
        "name": "fedavg_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/fedavg_agg/csrc/fedavg_agg.cu",
        "replaces": "src/repro/kernels/fedavg_agg/kernel.py:27",
        "launches": launches, "max_abs_err": summary["max_abs_err"],
        "ms": summary["kernel_ms"], "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": summary["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
