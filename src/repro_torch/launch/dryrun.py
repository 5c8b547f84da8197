"""Dry-run: count every (arch x input-shape) step on the ``meta`` device,
then give the roofline terms of one H100.

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each step against a TPU mesh of host devices and parses the
HLO.  Here the port's own step (``make_sharded_train_step``,
``make_prefill_step``, ``make_serve_step`` or ``make_fl_train_step``) is
built on ``device="meta"`` from ``abstract_params``, ``abstract_cache``
and ``input_specs`` and run once under ``op_analysis.analyze``: tensors
with shapes and dtypes and no storage, so nothing is allocated or
computed and a full-size step is counted on any host.  The hand-written
kernels count as their plain versions' work (``kernels/region.py``), so
a kernel made faster never moves its own yardstick.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k --mesh one
  python -m repro_torch.launch.dryrun --all      # every combo, subprocesses
Outputs JSON records under experiments/dryrun/.  Only ``--mesh one``
exists: ``single`` and ``multi`` wait for the multi-device slice.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional, Union

from ..configs import (ARCH_IDS, SHAPES, InputShape, ModelConfig, get_config,
                       input_specs, supports)
from ..tree import tree_leaves, tree_map
from . import op_analysis
from .mesh import HBM_BW, NVLINK_BW, peak_flops
from .serve import abstract_cache, make_serve_step
from .train import (abstract_params, make_fl_train_step, make_prefill_step,
                    make_sharded_train_step)

MESHES = ("one",)
# the replicas of the FL step, as the reference's two-pod mesh holds two
FL_REPLICAS = 2
WAITING_MESHES = ("single", "multi")


def roofline(cost, coll_bytes_per_dev, n_chips, cfg, shape, kind):
    """The three roofline terms (seconds) + useful-FLOPs ratio, on the
    card's constants (``launch/mesh.py``), with the peak of the step's
    parameter type.  ``bound_s`` is the largest term: the least time the
    card could take for the counted work."""
    flops_per_dev = float(cost.get("flops", 0.0) or 0.0)
    bytes_per_dev = float(cost.get("bytes accessed", 0.0) or 0.0)
    peak = peak_flops(cfg.param_dtype)
    t_compute = flops_per_dev / peak
    t_memory = bytes_per_dev / HBM_BW
    t_coll = coll_bytes_per_dev / NVLINK_BW
    # model flops: 6 N_active D for training, 2 N_active per generated token
    n_act = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * n_act * tokens
    elif kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        model_flops = 2.0 * n_act * tokens
    else:
        model_flops = 2.0 * n_act * shape.global_batch
    op_total = flops_per_dev * n_chips
    terms = [("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound_s": max(t for _, t in terms),
        "dominant": max(terms, key=lambda kv: kv[1])[0],
        "peak_flops": peak,
        "model_flops": model_flops,
        "op_flops_total": op_total,
        "useful_flops_ratio": model_flops / op_total if op_total else 0.0,
    }


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _step(cfg, shape, fl_step, fl_local, fl_agg_dtype):
    """The step on ``meta`` and its arguments: (fn, args, memory)."""
    params = abstract_params(cfg)
    p_bytes = _nbytes(params)
    if shape.kind == "train" and fl_step:
        n = FL_REPLICAS
        step = make_fl_train_step(cfg, n, shape, h_local=fl_local,
                                  agg_dtype=fl_agg_dtype, device="meta")
        reps = tree_map(lambda x: x.expand((n,) + tuple(x.shape))
                        .contiguous(), params)
        batch = {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
                 for k, x in input_specs(cfg, shape).items()}
        return step, (reps, batch), {"param_bytes": n * p_bytes,
                                     "grad_bytes": p_bytes}
    if shape.kind == "train":
        step = make_sharded_train_step(cfg, shape, device="meta")
        return step, (params, input_specs(cfg, shape)), {
            "param_bytes": p_bytes, "grad_bytes": p_bytes}
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, device="meta")
        return step, (params, input_specs(cfg, shape)), {
            "param_bytes": p_bytes}
    step = make_serve_step(cfg, device="meta", shape=shape)
    cache = abstract_cache(cfg, shape)
    inputs = input_specs(cfg, shape)["inputs"]
    return step, (params, cache, inputs, shape.seq_len - 1), {
        "param_bytes": p_bytes, "cache_bytes": _nbytes(cache)}


def run_one(arch: Union[str, ModelConfig], shape: Union[str, InputShape],
            mesh_kind: str = "one",
            remat: Optional[bool] = None, fl_step: bool = False,
            fl_local: int = 1,
            fl_agg_dtype: str = "float32") -> dict:
    """One step's record: flops and bytes as dispatched
    (``op_analysis.analyze``), PyTorch's own flop count beside them
    (``library_cost_flops_per_dev``; both from one run of the step, whose
    host seconds are ``count_s``), the bytes of params, grads and cache
    (``memory``) and the roofline.  ``arch`` is a registry name or a
    ``ModelConfig`` (a cut of depth, say); ``shape`` a ``SHAPES`` name or
    an ``InputShape``; ``fl_step`` counts ``make_fl_train_step`` over
    ``FL_REPLICAS`` replicas of ``fl_local`` local steps each."""
    if mesh_kind in WAITING_MESHES:
        raise ValueError(f"mesh {mesh_kind!r} is not supported by "
                         f"repro_torch yet (allowed: {MESHES}); it comes "
                         f"with the multi-device slice (ROADMAP)")
    if mesh_kind not in MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}; known: {MESHES}")
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
           "n_layers": cfg.n_layers, "fl_step": fl_step,
           "fl_local": fl_local, "fl_agg_dtype": fl_agg_dtype,
           "status": "skipped"}
    if not supports(cfg, shape):
        rec["reason"] = "full-attention arch without sub-quadratic variant"
        return rec
    t0 = time.perf_counter()
    fn, args, memory = _step(cfg, shape, fl_step, fl_local, fl_agg_dtype)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    costs, lib = op_analysis.analyze_with_library(fn, *args)
    t_count = time.perf_counter() - t0
    loop_cost = {"flops": costs.flops, "bytes accessed": costs.bytes}
    rec.update({
        "status": "ok",
        "n_chips": 1,
        "build_s": t_build,
        "count_s": t_count,
        # per-device numbers as dispatched (see op_analysis docstring)
        "flops_per_dev": costs.flops,
        "bytes_per_dev": costs.bytes,
        "collective_bytes_per_dev": dict(costs.collectives,
                                         total=costs.collective_total),
        # PyTorch's FlopCounterMode for reference (it counts no bytes)
        "library_cost_flops_per_dev": lib["flops"],
        "library_cost_bytes_per_dev": None,
        "memory": memory,
        "roofline": roofline(loop_cost, costs.collective_total, 1, cfg,
                             shape, shape.kind),
    })
    return rec


def main():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="one", choices=MESHES + WAITING_MESHES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--fl-step", action="store_true",
                    help="count the hierarchical-FL train step (paper eq.13)")
    ap.add_argument("--fl-local", type=int, default=1,
                    help="H local steps between aggregations (paper's H)")
    ap.add_argument("--fl-agg-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if args.mesh in WAITING_MESHES:
        ap.error(f"--mesh {args.mesh} comes with the multi-device slice "
                 f"(ROADMAP); only --mesh one exists")
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        failures = []
        for arch in ARCH_IDS:
            for shape in SHAPES:
                tag = f"{arch}_{shape}_{args.mesh}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip existing] {tag}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--mesh", args.mesh, "--out", args.out]
                print(f"[run] {tag}", flush=True)
                r = subprocess.run(cmd, capture_output=True, text=True)
                if r.returncode != 0:
                    failures.append(tag)
                    print(r.stdout[-2000:])
                    print(r.stderr[-4000:])
        print("failures:", failures)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    try:
        rec = run_one(args.arch, args.shape, args.mesh,
                      remat=(False if args.no_remat else None),
                      fl_step=args.fl_step, fl_local=args.fl_local,
                      fl_agg_dtype=args.fl_agg_dtype)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": traceback.format_exc()}
    suffix = ("_" + args.tag) if args.tag else ""
    if rec.get("fl_step"):
        suffix += "_flstep"
    tag = f"{args.arch}_{args.shape}_{args.mesh}{suffix}"
    path = os.path.join(args.out, tag + ".json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("error",)}, indent=2))
    if rec["status"] == "error":
        print(rec["error"])
        sys.exit(1)


if __name__ == "__main__":
    main()
