#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

1. ``card``: the card's name and power limit (nvidia-smi), the CUDA
   version, and the build of every hand-written kernel from the sources
   in this checkout (one nvcc per source, all started together), with
   each kernel's registers and spills from ptxas; the tensor-core
   attention kernel must not spill.
2. ``main_path``: the port's FL round loop at the paper's default setup
   (``run_fl(FLConfig(n_rounds=3))``: MNIST CNN, 50 devices, 5 air
   nodes, H=5, batched on the card), with every kernel's launch count
   set to 0 just before and read just after: one ``fedavg_agg`` launch a
   round, every leaf of both size buckets.
3. ``round_profile``: one steady round of that setup under
   ``torch.profiler``: the card's busy share and kernel time by name.
4. ``kernel``: the round aggregate as the main path issues it (every
   MNIST leaf over its two buckets, one launch), against its plain
   PyTorch version and beside one ``tensordot`` a leaf on the
   concatenated stack; the cross-region merge at ``multi_region`` (4
   region models, one at weight 0, one launch); then each leaf alone and
   VGG-11's flat buffer; float32 and bfloat16, with the error, the
   tolerance and CUDA-event times of the kernel, the plain version and
   the library call (on the card alone, from a replayed CUDA graph, and
   issued eagerly from Python), beside the least time the card could
   take (``bound_ms``).
5. ``card_vs_cpu``: two batched rounds of the same setup from the same
   initial params on the card and on the CPU, TF32 off for matmul and
   cuDNN, cuDNN deterministic: plan cases, latencies and wall clocks
   identical, accuracies within 4/eval_size, and params within 1e-4
   round by round (each card round from the CPU's params before it);
   beside them the free-running gap and the CPU's own spread from an
   init moved by one part in 1e7.
6. ``vgg11``: two rounds of ``dataset="cifar10"`` (VGG-11, lr 0.005),
   the largest aggregate the kernel sees.
7. ``propagation``: the coverage windows of ``paper`` (80 satellites,
   48 h at 10 s) and ``mega_constellation`` (1,080 satellites, 2
   regions, 6 h) with the torch backend on the card against NumPy:
   every interval identical; host times of both.
8. ``scenario_paper``: ``run_fl`` with ``scenario="paper"`` and with
   ``use_constellation=True``, 3 rounds at the paper's setup on the
   card: one ``fedavg_agg`` launch a round; plan cases, realized
   latencies and wall clocks identical to the same run on the CPU,
   accuracies within 4/eval_size (TF32 off).
9. ``engine_fl``: ``SAGINEngine("multi_region", fl=FLConfig(n_devices=20,
   n_air=2), backend="torch").run(4)``: 4 regions, propagation on the
   card, a ring merge every 2 rounds; ``fedavg_agg`` launches = one a
   region-round plus one a merge; event order and first merge identical
   to a 2-round CPU run; round and merge walls.
10. ``engine_chaos``: ``SAGINEngine("chaos", fl=FLConfig(n_devices=12,
    n_air=2)).run(6)``: every fault kind injected and recovered,
    quarantined updates counted, finite global params.
11. ``transformer_prefill``: full-width ``llama3.2-3b`` (random bf16
    weights from a seed), ``make_prefill_step`` on B = 4 sequences of
    2048 tokens: one ``flash_attention`` launch per layer (28), finite
    logits, wall time, peak memory and the kernel's share of the step
    under ``torch.profiler``.
12. ``transformer_decode``: the same model behind ``TransformerBackend``
    (seq_len 2048) answering batches of 8 requests: per-token latency.
13. ``decode_vs_prefill``: the same model in float32 (TF32 off), B = 1:
    the prefill's logits at all 256 positions (through the kernel)
    against 256 plain ``serve_step``s; then full-width ``rwkv6-1.6b``
    the same way over 64 positions (prefill through ``wkv6``, decode
    through the plain ``wkv_step``).
14. ``rwkv6``: full-width ``rwkv6-1.6b`` in bf16, prefill of B = 4 x 2048
    tokens (one ``wkv6`` launch per layer, 24) and decode steps; the
    smallest decay ``w`` the prefill feeds the kernel, and each layer's
    0.1 % quantile of it.
15. ``flash_kernel`` / ``wkv_kernel``: each kernel against its plain
    version on the card at the shapes the main paths gave it (in their
    bf16 and in f32) and over the reference's sweep, f32 and bf16, with
    decays from [0.7, 0.999] and (wkv) also from [0, 0.999] with exact
    zeros, timed as in phase 4 beside the library call
    (``scaled_dot_product_attention``; none for wkv) and ``bound_ms``;
    for flash also the achieved TFLOP/s and the share of the bound.

Every path is driven with every kernel's launch count set to 0 just
before it and read just after; ``fedavg_agg``'s count in the kernel
line sums its paths (phases 2, 8 and 9).  Then a ``{"kernels": [...]}``
line and, last, the device line.  Any failed phase, a missing CUDA
device, or a directory without the rest of the repository gives a
non-zero exit and no result line.
"""
from __future__ import annotations

import json
import math
import re
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
# f32: the reference's tolerances (tests/test_kernels.py).  bf16: kernel
# and plain version both sum in f32 from the same bf16 inputs and round
# the output once; the tensor-core flash kernel also rounds the
# probabilities to bf16 before P.V, so they differ by about two bf16
# roundings (2**-8 relative each); the limit leaves room over that and
# stays well below the outputs' own size (a causal row over n random keys
# is ~sqrt(e/n), 0.036 at n = 2048, so the reference's 5e-2 would pass a
# wrong kernel)
FLASH_TOLERANCE = {"float32": 2e-5, "bfloat16": 1e-2}
# wkv bf16: the tensor-core kernel multiplies the factored operands (r and
# k times their decays, the intra-chunk scores, the state) as bf16 high
# and low parts, ~2**-17 of each; one bf16 rounding of them instead would
# put ~2**-9 of the state's size (not the output's) on every output and
# miss the limit where outputs are small
WKV_TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}


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


def set_counts(launchers: dict) -> None:
    """Every kernel wrapper's launch count to 0."""
    for fn in launchers.values():
        fn.launches = 0


def read_counts(launchers: dict) -> dict:
    return {name: fn.launches for name, fn in launchers.items()}


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
    reports = [ptxas_report((lib.parent / "build.log").read_text())
               for lib in libs]
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernel_build_s": build_s,
          "ptxas": {str(lib.relative_to(ROOT)): ptxas
                    for lib, ptxas in zip(libs, reports)},
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32}})
    spilled = [name for ptxas in reports for name, rec in ptxas.items()
               if "wgmma" in name and name != "notes"
               and (rec["spill_stores"] or rec["spill_loads"])]
    if spilled:
        raise RuntimeError(f"the tensor-core kernel spills registers: "
                           f"{spilled}")


def ptxas_report(log: str) -> dict:
    """Registers and spills of each kernel in nvcc's ``-Xptxas -v``
    report (``build.log``), by mangled kernel name; ptxas's performance
    notes (wgmma serialized, setmaxnreg ignored) under ``notes``."""
    out, name = {"notes": []}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if "Performance Loss" in ln or "setmaxnreg" in ln:
            out["notes"].append(ln.strip()[:300])
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_main_path(launchers):
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.obs import ObsConfig, Tracer
    cfg = FLConfig(n_rounds=3)
    tracer = Tracer(ObsConfig(path=None))
    set_counts(launchers)
    t0 = time.perf_counter()
    res = run_fl(cfg, tracer=tracer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(launchers)
    launches = counts["fedavg_agg"]
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
    split = [s.attrs["clients"] for s in tracer.spans
             if s.kind == "bucket_dispatch" and s.round == 0]
    # batched: one launch a round for every leaf of every bucket
    ok = (cfg.resolved_execution() == "batched"
          and launches == cfg.n_rounds
          and all(math.isfinite(a) for a in res.accuracies)
          and all(res.participated))
    emit({"phase": "main_path", "ok": ok, "config": "FLConfig(n_rounds=3)",
          "execution": cfg.resolved_execution(), "wall_s": wall,
          "round_wall_s": per_round, "accuracies": res.accuracies,
          "losses": res.losses, "latencies": res.latencies,
          "cases": res.cases, "buckets": buckets,
          "clients_per_round": clients, "bucket_clients_round0": split,
          "fedavg_agg_launches": launches, "launches": counts})
    if not ok:
        raise RuntimeError("main path: not one fedavg_agg launch a round, "
                           "or non-finite accuracies")
    return launches, split


def phase_round_profile():
    """One steady round of the main path under ``torch.profiler``: the
    card's busy share of the round's wall time and its kernel time by
    name, with ``fedavg_agg``'s own share."""
    import torch
    from repro_torch.fl import FLConfig, RegionTrainer
    tr = RegionTrainer(FLConfig(n_rounds=2))
    tr.step(0)
    torch.cuda.synchronize()
    wall_ms, by_name = _profile(lambda: tr.step(1))
    # "Cat": the concatenation kernels, which the round no longer runs on
    # the aggregate's way
    emit({"phase": "round_profile", "round_wall_ms": wall_ms,
          **_share(by_name, wall_ms, "fedavg_agg", "Cat")})


def _bound(nbytes, ops, dtype_name):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of ``dtype_name``, the larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def _times(fns: dict, big: bool) -> dict:
    """CUDA-graph (card) and eager times of each callable in ``fns``;
    fewer calls for a case that takes milliseconds."""
    reps, repeats = (4, 3) if big else (20, 5)
    out = {}
    for key, fn in fns.items():
        if fn is None:
            out[f"{key}_ms"] = out[f"{key}_eager_ms"] = None
            continue
        t = time_ms(fn, reps=reps, repeats=repeats)
        out[f"{key}_ms"], out[f"{key}_eager_ms"] = t["device"], t["eager"]
    return out


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
    return {
        "shape": list(shape), "dtype": dtype_name,
        "max_abs_err": float(diff.max()), "tolerance": tol, "ok": ok,
        **_times({"kernel": lambda: kernel.weighted_aggregate(x, w),
                  "plain": lambda: ref.weighted_aggregate(x, w),
                  "library": lambda: torch.tensordot(w_lib, x, dims=1)},
                 big=False),
        **_bound(nbytes, 2 * c * p, dtype_name),
    }


def _round_case(kernel, ref, leaf_shapes, split, dtype_name, seed,
                zero=None):
    """The round aggregate as the main path issues it: every leaf over the
    size buckets (clients ``split``), one launch, against the plain
    version (which concatenates the buckets), beside one ``tensordot`` a
    leaf on the concatenated stacks (the yardstick) and beside the same
    kernel launched once a leaf on them.  ``zero``: the client whose
    weight is 0 (a region that sits a merge out)."""
    import torch
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    parts = [[torch.randn((c,) + shape, generator=gen,
                          device="cuda").to(dtype) for shape in leaf_shapes]
             for c in split]
    w = torch.rand(sum(split), generator=gen, device="cuda") + 0.1
    if zero is not None:
        w[zero] = 0.0
    w = w / w.sum()
    w_lib = w.to(dtype)  # the library call takes one type throughout
    stacks = [torch.cat(leaves) for leaves in zip(*parts)]
    got = kernel.aggregate(parts, w)
    want = ref.aggregate(parts, w)
    torch.cuda.synchronize()
    tol = TOLERANCE[dtype_name]
    diffs = [(a.float() - b.float()).abs() for a, b in zip(got, want)]
    ok = all(bool((d <= tol * (1 + b.float().abs())).all())
             for d, b in zip(diffs, want))
    elt = stacks[0].element_size()
    nbytes = (sum(x.numel() + x[0].numel() for x in stacks) * elt
              + 4 * sum(split))
    return {
        "split": list(split), "leaves": len(leaf_shapes),
        "dtype": dtype_name,
        "max_abs_err": max(float(d.max()) for d in diffs), "tolerance": tol,
        "ok": ok,
        **_times({"kernel": lambda: kernel.aggregate(parts, w),
                  "plain": lambda: ref.aggregate(parts, w),
                  "library": lambda: [torch.tensordot(w_lib, x, dims=1)
                                      for x in stacks],
                  "per_leaf": lambda: [kernel.weighted_aggregate(x, w)
                                       for x in stacks]},
                 big=False),
        **_bound(nbytes, 2 * sum(x.numel() for x in stacks), dtype_name),
    }


def phase_kernel(agg_kernel, agg_ref, split):
    import torch
    from repro_torch.models.cnn import build_model
    from repro_torch.tree import tree_leaves
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    leaf_shapes = [tuple(t.shape) for t in tree_leaves(params)]
    clients = sum(split)
    rounds = {d: _round_case(agg_kernel, agg_ref, leaf_shapes, split, d, 7)
              for d in ("float32", "bfloat16")}
    for case in rounds.values():
        emit({"phase": "kernel", "kernel": "fedavg_agg",
              "model": "mnist round aggregate (every leaf, both buckets, "
                       "one launch)", **case})
    # the cross-region merge at multi_region: 4 region models stacked
    # (one bucket), every leaf in one launch, one region at weight 0
    merge = _round_case(agg_kernel, agg_ref, leaf_shapes, [4], "float32",
                        8, zero=2)
    emit({"phase": "kernel", "kernel": "fedavg_agg",
          "model": "multi_region merge (4 regions, one at weight 0, every "
                   "leaf, one launch)", **merge})
    rounds["merge"] = merge
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
    bad = ([k for k, v in cases.items() if not v["ok"]]
           + [k for k, v in rounds.items() if not v["ok"]])
    if bad:
        raise RuntimeError(f"fedavg_agg disagrees with its plain version: "
                           f"{bad}")
    return rounds["float32"]


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
    ok = (launches == cfg.n_rounds
          and all(math.isfinite(v) for v in res.accuracies + res.losses))
    emit({"phase": "vgg11", "ok": ok, "config": cfg.dataset, "lr": cfg.lr,
          "round_wall_s": per_round, "accuracies": res.accuracies,
          "losses": res.losses, "fedavg_agg_launches": launches,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not ok:
        raise RuntimeError("VGG-11 rounds: not one launch a round, or "
                           "non-finite accuracies or losses")


def _wall(run):
    """``run()``'s result and its host seconds, ended by a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_propagation():
    """Coverage windows of ``paper`` (80 satellites, 48 h at 10 s) and
    ``mega_constellation`` (1,080 satellites, 2 regions, 6 h) with the
    torch backend on the card against NumPy: every interval identical.
    Times on the host clock: the whole ``access_intervals_multi`` and
    ``visibility`` alone (the part that runs on the card), each the
    median of 5 calls after one that warms both backends up."""
    import numpy as np
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import propagation as P

    def median_wall(run):
        walls = [_wall(run) for _ in range(5)]
        return walls[0][0], statistics.median(w for _, w in walls)

    out, ok = {}, True
    for name in ("paper", "mega_constellation"):
        scn = get_scenario(name)
        ws = scn.build_constellation()
        t = np.arange(0.0, scn.horizon, scn.dt)
        for backend in ("torch", "numpy"):
            P.access_intervals_multi(ws, scn.regions, scn.horizon, scn.dt,
                                     backend=backend)
        got, torch_s = median_wall(lambda: P.access_intervals_multi(
            ws, scn.regions, scn.horizon, scn.dt, backend="torch"))
        want, numpy_s = median_wall(lambda: P.access_intervals_multi(
            ws, scn.regions, scn.horizon, scn.dt, backend="numpy"))
        vis_torch, vis_torch_s = median_wall(lambda: P.visibility(
            ws, scn.regions, t, backend="torch"))
        vis_numpy, vis_numpy_s = median_wall(lambda: P.visibility(
            ws, scn.regions, t, backend="numpy"))
        same = all([(i.sat, i.start, i.end) for i in got[r]]
                   == [(i.sat, i.start, i.end) for i in want[r]]
                   for r in want) and list(got) == list(want)
        same_mask = bool((vis_torch == vis_numpy).all())
        ok = ok and same and same_mask
        out[name] = {"shape": [len(scn.regions), len(t), ws.n_sats],
                     "intervals": {r: len(v) for r, v in want.items()},
                     "intervals_identical": same,
                     "mask_identical": same_mask,
                     "torch_s": torch_s, "numpy_s": numpy_s,
                     "visibility_torch_s": vis_torch_s,
                     "visibility_numpy_s": vis_numpy_s}
    emit({"phase": "propagation", "ok": ok, **out})
    if not ok:
        raise RuntimeError("propagation: the card's windows differ from "
                           "NumPy's")


def _tf32_off():
    """TF32 off for matmul and cuDNN, cuDNN deterministic; returns the
    settings to restore."""
    import torch
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = True
    return saved


def _restore(saved):
    import torch
    b = torch.backends
    (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
     b.cudnn.deterministic) = saved


def phase_scenario_paper(launchers):
    """``run_fl`` with the Walker-Star constellation setting each round's
    T_i — the paper preset (48 h of windows) and the bare constellation —
    at the paper's 50 devices, 5 air nodes and the MNIST CNN, 3 rounds on
    the card: one ``fedavg_agg`` launch a round.  The same run with
    ``device="cpu"`` gives identical plan cases, realized latencies and
    wall clocks, and accuracies within 4/eval_size (TF32 off on both)."""
    import torch
    from repro_torch.fl import FLConfig, run_fl
    from repro_torch.models.cnn import build_model
    from repro_torch.obs import ObsConfig, Tracer
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    total, out, ok = 0, {}, True
    saved = _tf32_off()
    try:
        for label, kw in (("scenario=paper", dict(scenario="paper")),
                          ("use_constellation", dict(use_constellation=True))):
            cfg = FLConfig(n_rounds=3, **kw)
            tracer = Tracer(ObsConfig(path=None))
            set_counts(launchers)
            res, wall = _wall(lambda: run_fl(cfg, tracer, params=params))
            launches = read_counts(launchers)["fedavg_agg"]
            total += launches
            cpu = run_fl(FLConfig(n_rounds=3, device="cpu", **kw),
                         params=params)
            ends = [s.t_wall for s in tracer.spans if s.kind == "round"]
            acc_err = max(abs(a - b) for a, b in zip(res.accuracies,
                                                     cpu.accuracies))
            good = (launches == cfg.n_rounds and res.cases == cpu.cases
                    and res.latencies == cpu.latencies
                    and res.times == cpu.times
                    and acc_err <= 4 / cfg.eval_size
                    and all(math.isfinite(a) for a in res.accuracies))
            ok = ok and good
            out[label] = {
                "ok": good, "execution": cfg.resolved_execution(),
                "fedavg_agg_launches": launches, "wall_s": wall,
                "round_wall_s": [b - a for a, b in zip(ends, ends[1:])],
                "cases": res.cases, "latencies": res.latencies,
                "times": res.times, "accuracies": res.accuracies,
                "cpu_accuracies": cpu.accuracies,
                "max_accuracy_err": acc_err,
                "accuracy_tolerance": 4 / cfg.eval_size,
                "cases_latencies_times_equal": (
                    res.cases == cpu.cases and res.latencies == cpu.latencies
                    and res.times == cpu.times)}
    finally:
        _restore(saved)
    emit({"phase": "scenario_paper", "ok": ok, "tf32": False, **out})
    if not ok:
        raise RuntimeError("scenario_paper: not one fedavg_agg launch a "
                           "round, or card and CPU runs disagree")
    return total


def _timed_engine(engine):
    """Wrap the engine's trainers' steps and its merge with host clocks
    that end in a synchronize; returns the lists they fill."""
    import torch
    steps, merges = [], []

    def timed(fn, sink):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out
        return run

    for t in engine.trainers:
        t.step = timed(t.step, steps)
    engine._policy_merge = timed(engine._policy_merge, merges)
    return steps, merges


def _merge_fields(ev):
    return [ev.barrier_round, ev.time, list(ev.staleness), list(ev.weights),
            list(ev.isl_costs), ev.policy, ev.hub, list(ev.participants),
            list(ev.recipients)]


def phase_engine_fl(launchers):
    """``SAGINEngine("multi_region", fl=FLConfig(n_devices=20, n_air=2),
    backend="torch").run(4)`` on the card: 4 regions x 20 devices x 2 air
    nodes, propagation on the card, a synchronous ring merge every 2
    rounds.  ``fedavg_agg`` launches = one a region-round plus one a
    merge; the event order and the first merge's weights, staleness, ISL
    costs and time are those of a 2-round run with ``device="cpu"``.
    Then one more round of every region and its merge under
    ``torch.profiler``: the card's busy share."""
    from repro_torch.fl import FLConfig
    from repro_torch.sim import SAGINEngine
    fl = FLConfig(n_devices=20, n_air=2)
    (eng, build_s) = _wall(lambda: SAGINEngine("multi_region", fl=fl,
                                               backend="torch"))
    steps, merges = _timed_engine(eng)
    set_counts(launchers)
    _, run_s = _wall(lambda: eng.run(4))
    launches = read_counts(launchers)["fedavg_agg"]
    trained = sum(sum(t.result.participated) for t in eng.trainers)
    merged = sum(len(m.participants) > 1 for m in eng.merges)
    cpu = SAGINEngine("multi_region", fl=FLConfig(n_devices=20, n_air=2,
                                                  device="cpu"))
    cpu.run(2)
    n_cpu = len(cpu.step_order)
    same = (eng.step_order[:n_cpu] == cpu.step_order
            and _merge_fields(eng.merges[0]) == _merge_fields(cpu.merges[0]))
    regions = len(eng.trainers)
    ok = (launches == trained + merged and len(eng.merges) == 2
          and trained == 16 and same
          and all(math.isfinite(a) for m in eng.merges
                  for a in m.accuracies))
    rec = {"phase": "engine_fl", "ok": ok, "scenario": "multi_region",
           "regions": regions, "n_devices": fl.n_devices, "n_air": fl.n_air,
           "execution": fl.resolved_execution(), "propagation": "torch",
           "build_s": build_s, "run_s": run_s, "round_wall_s": list(steps),
           # past each region's first round
           "steady_round_wall_s_median": statistics.median(steps[regions:]),
           "merge_wall_s": list(merges),
           "fedavg_agg_launches": launches, "region_rounds": trained,
           "merges": [_merge_fields(m) + [list(m.accuracies)]
                      for m in eng.merges],
           "cpu_first_merge": _merge_fields(cpu.merges[0]),
           "step_order_and_first_merge_equal_cpu": same,
           "summary": eng.summary()}
    prof_wall, by_name = _profile(lambda: eng.run(1))
    emit({**rec, "profiled_round_and_merge": _share(by_name, prof_wall,
                                                    "fedavg_agg")})
    if not ok:
        raise RuntimeError("engine_fl: fedavg_agg launches != region-rounds "
                           "+ merges, or the merges differ from the CPU's")
    return launches


def phase_engine_chaos(launchers):
    """``SAGINEngine("chaos", fl=FLConfig(n_devices=12, n_air=2)).run(6)``
    on the card (3 regions): every fault kind injected and recovered at
    least once, in-round faults always absorbed, quarantined updates
    counted, finite global params."""
    import torch
    from repro_torch.fl import FLConfig
    from repro_torch.obs import ObsConfig
    from repro_torch.resilience import FAULT_KINDS
    from repro_torch.sim import SAGINEngine
    from repro_torch.tree import tree_leaves
    eng = SAGINEngine("chaos", fl=FLConfig(n_devices=12, n_air=2,
                                           obs=ObsConfig(path=None)))
    set_counts(launchers)
    _, run_s = _wall(lambda: eng.run(6))
    launches = read_counts(launchers)["fedavg_agg"]
    inj = eng.fault_injector
    quarantined = eng.tracer.metrics.counter("quarantine.updates").value
    finite = eng.global_params is not None and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(eng.global_params))
    ok = (all(inj.injected[k] > 0 and inj.recovered[k] > 0
              for k in FAULT_KINDS)
          and all(inj.recovered[k] >= inj.injected[k]
                  for k in ("sat_loss", "straggler", "nan_update",
                            "trainer_crash"))
          and quarantined > 0 and finite)
    emit({"phase": "engine_chaos", "ok": ok, "regions": len(eng.trainers),
          "execution": eng.trainers[0].execution, "run_s": run_s,
          "injected": dict(inj.injected), "recovered": dict(inj.recovered),
          "quarantined_updates": quarantined, "global_params_finite": finite,
          "merges": [_merge_fields(m) for m in eng.merges],
          "fedavg_agg_launches": launches})
    if not ok:
        raise RuntimeError("engine_chaos: a fault kind was not injected and "
                           "recovered, or the global params are not finite")


def _free() -> None:
    """Return the cached blocks of the tensors dropped so far."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _profile(run):
    """``run()`` once under ``torch.profiler``: wall ms, and device ms
    and count by kernel name.  Device activity only, so that the host
    side runs at its own pace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if ev.device_type == DeviceType.CUDA and dev_us > 0:
            ms, n = by_name.get(ev.key, (0.0, 0))
            by_name[ev.key] = (ms + dev_us / 1e3, n + ev.count)
    return wall_ms, by_name


def _share(by_name, wall_ms, *needles):
    """The card's busy ms and share of the wall ms, the top kernels and,
    for each of ``needles``, the device ms of the kernels whose name
    holds it."""
    if not by_name:
        return {"profile": "not measured"}
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"profile_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_share": busy / wall_ms,
           "kernels": sum(n for _, n in by_name.values()),
           "top_kernels_ms": [[name[:80], ms, n] for name, (ms, n) in top]}
    for needle in needles:
        own = [(ms, n) for name, (ms, n) in by_name.items()
               if needle in name]
        out.update({f"{needle}_ms": sum(ms for ms, _ in own),
                    f"{needle}_kernels": sum(n for _, n in own),
                    f"{needle}_share_of_busy":
                        sum(ms for ms, _ in own) / busy})
    return out


def _prefill_run(launchers, cfg, batch, seq, needle):
    """Full-width prefill of ``cfg`` (random weights from seed 0) through
    ``make_prefill_step``: one warm-up call, then the counted call and a
    profiled one.  Returns the record and the counts."""
    import torch
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill = make_prefill_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch_in = {"inputs": torch.randint(0, cfg.vocab_size, (batch, seq),
                                        generator=gen, device="cuda")}
    prefill(params, batch_in)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    set_counts(launchers)
    t0 = time.perf_counter()
    logits = prefill(params, batch_in)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts(launchers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    shape_ok = tuple(logits.shape) == (batch, cfg.padded_vocab)
    prof_wall, by_name = _profile(lambda: prefill(params, batch_in))
    rec = {"config": cfg.name, "dtype": cfg.param_dtype, "batch": batch,
           "seq_len": seq,
           "params": sum(t.numel() for t in tree_leaves(params)),
           "init_s": init_s, "wall_s": wall_s,
           "tokens_per_s": batch * seq / wall_s, "peak_memory_gib": peak,
           "logits_shape": list(logits.shape), "logits_finite": finite,
           "launches": counts, **_share(by_name, prof_wall, needle)}
    del params, logits
    _free()
    return rec, counts, finite and shape_ok


def phase_transformer_prefill(launchers, batch=4, seq=2048):
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-3b")
    rec, counts, ok = _prefill_run(launchers, cfg, batch, seq,
                                   "flash_attention")
    ok = ok and counts["flash_attention"] == cfg.n_layers
    emit({"phase": "transformer_prefill", "ok": ok, **rec})
    if not ok:
        raise RuntimeError("llama3.2-3b prefill: flash_attention launches "
                           "!= n_layers or non-finite logits")
    return counts["flash_attention"], {
        "q": (batch, cfg.n_heads, seq, cfg.head_dim),
        "kv_heads": cfg.n_kv_heads, "window": cfg.sliding_window}


def phase_transformer_decode(launchers, batch=8, steps=32):
    """``TransformerBackend`` at full width answering ``steps`` batches of
    ``batch`` requests, after 3 that warm it up (the first allocates the
    cache).  ``predict`` ends in a synchronize, so the host clock around
    it is the request's latency."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve import TransformerBackend
    from repro_torch.tree import tree_leaves
    cfg = get_config("llama3.2-3b")
    be = TransformerBackend(model_cfg=cfg, seq_len=2048)
    rng = np.random.default_rng(0)
    for _ in range(3):
        be.predict(0, None, rng.integers(0, 1 << 20, size=batch))
    set_counts(launchers)
    lat = []
    for _ in range(steps):
        samples = rng.integers(0, 1 << 20, size=batch)
        t0 = time.perf_counter()
        be.predict(0, None, samples)
        lat.append(time.perf_counter() - t0)
    counts = read_counts(launchers)
    finite = bool(torch.isfinite(be.last_logits).all())
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(be._caches[batch]))
    # one more step under the profiler: how long the card is busy
    samples = rng.integers(0, 1 << 20, size=batch)
    wall_ms, by_name = _profile(lambda: be.predict(0, None, samples))
    ok = finite and be._pos[batch] == steps + 4
    emit({"phase": "transformer_decode", "ok": ok, "config": cfg.name,
          "batch": batch, "seq_len": be.seq_len, "steps": steps,
          "per_token_ms_median": statistics.median(lat) * 1e3,
          "per_token_ms_mean": statistics.mean(lat) * 1e3,
          "per_token_ms_max": max(lat) * 1e3,
          "tokens_per_s": batch / statistics.median(lat),
          "cache_gib": cache_bytes / 2**30, "logits_finite": finite,
          "launches": counts,
          "profiled_step": _share(by_name, wall_ms)})
    del be
    _free()
    if not ok:
        raise RuntimeError("llama3.2-3b decode: non-finite logits")


# float32 with TF32 off: prefill and decode take every product through
# other kernels (GEMM vs GEMV; flash_attention vs the decode softmax, or
# wkv6 vs the plain wkv_step), which sum in other orders; ~6e-8 relative
# per rounding over 24-28 layers of 2048-3072-wide sums leaves logits of
# magnitude ~1-5 (a normed hidden state times a 1/sqrt(d) unembedding)
# within ~1e-4, and 1e-3 keeps a decade of room
DECODE_VS_PREFILL_TOL = 1e-3


def _decode_vs_prefill(launchers, name, kernel, seq, n_layers=None):
    """Full-width ``name`` in float32, B = 1, at its own depth or cut to
    ``n_layers``: the prefill's logits at all ``seq`` positions (through
    ``kernel``, one launch a layer) against ``seq`` plain
    ``serve_step``s.  Returns the config."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(name), param_dtype="float32")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    backends = torch.backends
    saved = (backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32)
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.allow_tf32 = False
    try:
        params = T.init_params(cfg, seed=1, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                               device="cuda")
        set_counts(launchers)
        with torch.no_grad():
            full, _ = T.logits_fn(params, cfg, tokens)
        torch.cuda.synchronize()
        counts = read_counts(launchers)
        step = make_serve_step(cfg)
        cache = T.init_cache(cfg, 1, seq, device="cuda")
        diffs = []
        t0 = time.perf_counter()
        for pos in range(seq):
            logits, cache = step(params, cache, tokens[:, pos:pos + 1], pos)
            diffs.append((logits[0] - full[0, pos]).abs().max())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        err = float(torch.stack(diffs).max())
        scale = float(full.abs().max())
    finally:
        backends.cuda.matmul.allow_tf32, backends.cudnn.allow_tf32 = saved
    ok = (counts[kernel] == cfg.n_layers
          and math.isfinite(err) and err <= DECODE_VS_PREFILL_TOL)
    emit({"phase": "decode_vs_prefill", "ok": ok, "config": cfg.name,
          "n_layers": cfg.n_layers, "dtype": "float32", "tf32": False,
          "seq_len": seq,
          "max_abs_err": err, "tolerance": DECODE_VS_PREFILL_TOL,
          "max_abs_logit": scale, "decode_s": decode_s,
          "launches": counts})
    del params, full, cache
    _free()
    if not ok:
        raise RuntimeError(f"{name}: decode and prefill logits disagree "
                           f"or {kernel} launches != n_layers")
    return cfg


def phase_decode_vs_prefill(launchers):
    """llama3.2-3b over 256 positions, then rwkv6-1.6b over 64.

    rwkv6-1.6b runs 2 of its 24 layers: with random weights its layers
    amplify a rounding difference with depth (at all 24 layers decode
    and prefill differed by ~1e-2 in f32 on the card, and the plain path
    on the CPU, with no kernel, widens the same way), so a cut depth
    holds the kernel to a tolerance that a wrong kernel would miss."""
    cfg = _decode_vs_prefill(launchers, "llama3.2-3b", "flash_attention",
                             256)
    _decode_vs_prefill(launchers, "rwkv6-1.6b", "wkv6", 64, n_layers=2)
    return {"q": (1, cfg.n_heads, 256, cfg.head_dim),
            "kv_heads": cfg.n_kv_heads, "window": cfg.sliding_window}


def _prefill_decays(cfg, params, batch, seq):
    """The decays ``w`` that one more prefill (the same weights and
    tokens as ``_prefill_run``'s) feeds the ``wkv6`` kernel, read by a tap
    on the op's kernel module: their minimum, and each layer's 0.1 %
    quantile."""
    import torch
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch.train import make_prefill_step
    real = wkv_ops.kernel
    mins, quantiles = [], []

    class Tap:
        def wkv(self, r, k, v, w, u):
            flat = w.flatten().float()
            mins.append(float(flat.min()))
            kth = max(1, int(flat.numel() * 1e-3))
            quantiles.append(float(torch.kthvalue(flat, kth).values))
            return real.wkv(r, k, v, w, u)

    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    wkv_ops.kernel = Tap()
    try:
        make_prefill_step(cfg)(params, {"inputs": tokens})
        torch.cuda.synchronize()
    finally:
        wkv_ops.kernel = real
    return {"w_min": min(mins), "w_q001_per_layer": quantiles,
            "w_q001_min": min(quantiles)}


def phase_rwkv6(launchers, batch=4, seq=2048, decode_steps=8):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.models import transformer as T
    cfg = get_config("rwkv6-1.6b")
    rec, counts, ok = _prefill_run(launchers, cfg, batch, seq, "wkv6")
    ok = ok and counts["wkv6"] == cfg.n_layers
    params = T.init_params(cfg, seed=0, device="cuda")
    decays = _prefill_decays(cfg, params, batch, seq)
    # decode: a few steps from an empty state
    step = make_serve_step(cfg)
    cache = T.init_cache(cfg, batch, seq, device="cuda")
    tokens = torch.arange(batch, device="cuda")[:, None]
    lat = []
    for pos in range(decode_steps):
        t0 = time.perf_counter()
        logits, cache = step(params, cache, tokens + pos, pos)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits).all())
    ok = ok and finite
    emit({"phase": "rwkv6", "ok": ok, **rec, **decays,
          "decode_steps": decode_steps,
          "decode_per_token_ms_median": statistics.median(lat[1:]) * 1e3,
          "decode_logits_finite": finite})
    del params, cache, logits
    _free()
    if not ok:
        raise RuntimeError("rwkv6-1.6b: wkv6 launches != n_layers or "
                           "non-finite logits")
    h = cfg.d_model // 64
    return counts["wkv6"], (batch, h, seq, cfg.d_model // h)


def _flash_case(fa_kernel, fa_ref, q_shape, hkv, window, dtype_name, seed):
    """One kernel-vs-plain comparison of flash_attention, with times."""
    import torch
    import torch.nn.functional as F
    dtype = getattr(torch, dtype_name)
    b, hq, s, d = q_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(q_shape, generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=window)
    want = fa_ref.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = FLASH_TOLERANCE[dtype_name]
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    # the one PyTorch call that computes the same function (timed only)
    idx = torch.arange(s, device="cuda")
    if window is None or window >= s:
        def library():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        pairs = s * (s + 1) // 2
    else:
        mask = ((idx[None, :] <= idx[:, None])
                & (idx[None, :] > idx[:, None] - window))

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
        pairs = int(mask.sum())
    lib_err = float((library().float() - want.float()).abs().max())
    # q and out written/read once, k and v read once; 2 FLOP per
    # multiply-add of q.k and of p.v over the unmasked pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()
    ops = 4 * d * pairs * b * hq
    big = nbytes > 50e6
    times = _times({"kernel": lambda: fa_kernel.flash_attention(
                        q, k, v, causal=True, window=window),
                    "plain": lambda: fa_ref.attention(q, k, v, causal=True,
                                                      window=window),
                    "library": library}, big)
    bound = _bound(nbytes, ops, dtype_name)
    return {
        "q_shape": list(q_shape), "kv_heads": hkv, "window": window,
        "dtype": dtype_name, "max_abs_err": float(diff.max()),
        "tolerance": tol, "ok": ok, "library_max_abs_err": lib_err,
        **times, **bound,
        # achieved rate and the share of the bound the kernel reaches
        "kernel_tflops": ops / times["kernel_ms"] / 1e9,
        "bound_share": bound["bound_ms"] / times["kernel_ms"],
    }


FLASH_SWEEP = [((1, 2, 128, 32), 2), ((2, 4, 256, 64), 2),
               ((1, 8, 128, 64), 1), ((2, 4, 512, 16), 4),
               ((2, 4, 200, 64), 2)]


def phase_flash_kernel(fa_kernel, fa_ref, prefill_shapes, f32_shapes):
    """The main path's shape in bf16 (as it runs) and in f32 (a tight
    check over its 32 KV tiles), the f32 ``decode_vs_prefill`` shape, and
    the reference's sweep; the plain version's f32 einsums with TF32
    off."""
    import torch
    main = (prefill_shapes["q"], prefill_shapes["kv_heads"],
            prefill_shapes["window"])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cases = {"main": _flash_case(fa_kernel, fa_ref, *main, "bfloat16",
                                     0),
                 "main-float32": _flash_case(fa_kernel, fa_ref, *main,
                                             "float32", 0),
                 "decode_vs_prefill": _flash_case(
                     fa_kernel, fa_ref, f32_shapes["q"],
                     f32_shapes["kv_heads"], f32_shapes["window"],
                     "float32", 1)}
        for i, (q_shape, hkv) in enumerate(FLASH_SWEEP):
            for window in (None, 64):
                for dtype_name in ("float32", "bfloat16"):
                    cases[f"sweep{i}-{window}-{dtype_name}"] = _flash_case(
                        fa_kernel, fa_ref, q_shape, hkv, window, dtype_name,
                        10 + i)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for name, case in cases.items():
        emit({"phase": "flash_kernel", "case": name, **case})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention disagrees with its plain "
                           f"version: {bad}")
    return cases["main"]


def _wkv_case(wkv_kernel, wkv_ref, shape, dtype_name, seed, w_lo=0.7):
    """One kernel-vs-plain comparison of wkv6, with times.  ``w_lo`` = 0:
    decays from [0, 0.999] with exact zeros (every 5th step of every 3rd
    channel), where a chunk's decay product underflows."""
    import torch
    dtype = getattr(torch, dtype_name)
    b, h, t, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(sh, scale=1.0):
        return (torch.randn(sh, generator=gen, device="cuda")
                * scale).to(dtype)

    r, k, v = normal(shape), normal(shape, 0.3), normal(shape)
    w = w_lo + (0.999 - w_lo) * torch.rand(shape, generator=gen,
                                           device="cuda")
    if w_lo == 0.0:
        w[:, :, ::5, ::3] = 0.0
    w = w.to(dtype)
    u = normal((h, d), 0.1)
    got = wkv_kernel.wkv(r, k, v, w, u)
    want = wkv_ref.wkv(r, k, v, w, u)  # the step-by-step oracle
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    tol = WKV_TOLERANCE[dtype_name]
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    if t % 64 == 0:  # the plain form the dispatcher takes off the card
        def plain():
            return wkv_ref.wkv_chunked(r, k, v, w, u, chunk=64)
    else:
        def plain():
            return wkv_ref.wkv(r, k, v, w, u)
    # r, k, v, w read and out written once, u read once
    nbytes = (5 * r.numel() + u.numel()) * r.element_size()
    if dtype_name == "bfloat16" and d >= 16:
        # the chunked form's tensor-core products as the kernel issues
        # them, per 16-step sub-chunk (T padded to 64-step chunks): the
        # cross term 3 x 2*16*d*d and the state update 2 x 2*16*d*d (hi
        # and lo parts), the intra term 2 x 2*16*16*d, at the bf16 rate
        subs = -(-t // 64) * 4
        bound = _bound(nbytes, b * h * subs * (160 * d * d + 1024 * d),
                       "bfloat16")
    else:
        # the recurrence on the CUDA cores, in f32: 2 FLOP per multiply-
        # add of the output's contraction with the state and of the
        # state's decay and update
        bound = _bound(nbytes, 4 * d * d * t * b * h, "float32")
    return {
        "shape": list(shape), "dtype": dtype_name, "w_lo": w_lo,
        "max_abs_err": float(diff.max()),
        "max_abs_out": float(want.float().abs().max()), "tolerance": tol,
        "ok": ok, "plain_form": "wkv_chunked" if t % 64 == 0 else "wkv",
        **_times({"kernel": lambda: wkv_kernel.wkv(r, k, v, w, u),
                  "plain": plain, "library": None}, nbytes > 50e6),
        **bound,
    }


WKV_SWEEP = [(1, 1, 32, 8), (2, 3, 64, 16), (1, 2, 128, 64), (2, 2, 96, 32),
             (2, 4, 200, 64)]


def phase_wkv_kernel(wkv_kernel, wkv_ref, main_shape):
    cases = {}
    for w_lo, tag in ((0.7, ""), (0.0, "-strong")):
        cases[f"main{tag}"] = _wkv_case(wkv_kernel, wkv_ref, main_shape,
                                        "bfloat16", 0, w_lo)
        cases[f"main{tag}-float32"] = _wkv_case(
            wkv_kernel, wkv_ref, main_shape, "float32", 0, w_lo)
        for i, shape in enumerate(WKV_SWEEP):
            for dtype_name in ("float32", "bfloat16"):
                cases[f"sweep{i}{tag}-{dtype_name}"] = _wkv_case(
                    wkv_kernel, wkv_ref, shape, dtype_name, 10 + i, w_lo)
    for name, case in cases.items():
        emit({"phase": "wkv_kernel", "case": name, **case})
    bad = [k for k, v in cases.items() if not v["ok"]]
    if bad:
        raise RuntimeError(f"wkv6 disagrees with its plain version: {bad}")
    return cases["main"]


def _kernel_line(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"]}


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
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.kernels.wkv6 import kernel as wkv_kernel
        from repro_torch.kernels.wkv6 import ref as wkv_ref
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch ({exc}); run it from "
              f"the root of a checkout", file=sys.stderr)
        return 2
    launchers = {"fedavg_agg": agg_kernel.weighted_aggregate,
                 "flash_attention": fa_kernel.flash_attention,
                 "wkv6": wkv_kernel.wkv}
    try:
        phase_card([agg_kernel, fa_kernel, wkv_kernel])
        launches, split = phase_main_path(launchers)
        phase_round_profile()
        summary = phase_kernel(agg_kernel, agg_ref, split)
        phase_card_vs_cpu(agg_kernel)
        phase_vgg11(agg_kernel)
        phase_propagation()
        launches += phase_scenario_paper(launchers)
        launches += phase_engine_fl(launchers)
        phase_engine_chaos(launchers)
        fa_launches, prefill_shapes = phase_transformer_prefill(launchers)
        phase_transformer_decode(launchers)
        f32_shapes = phase_decode_vs_prefill(launchers)
        wkv_launches, wkv_shape = phase_rwkv6(launchers)
        fa_case = phase_flash_kernel(fa_kernel, fa_ref, prefill_shapes,
                                     f32_shapes)
        wkv_case = phase_wkv_kernel(wkv_kernel, wkv_ref, wkv_shape)
    except Exception:  # report the failed phase, then fail the run
        traceback.print_exc()
        emit({"phase": "failed", "error": traceback.format_exc(limit=3)})
        return 1
    emit({"kernels": [
        _kernel_line("fedavg_agg", "src/repro_torch/kernels/fedavg_agg/"
                     "csrc/fedavg_agg.cu",
                     "src/repro/kernels/fedavg_agg/kernel.py:27", launches,
                     summary),
        _kernel_line("flash_attention", "src/repro_torch/kernels/"
                     "flash_attention/csrc/flash_attention_wgmma.cuh",
                     "src/repro/kernels/flash_attention/kernel.py:76",
                     fa_launches, fa_case),
        _kernel_line("wkv6", "src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6/kernel.py:53", wkv_launches,
                     wkv_case)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
