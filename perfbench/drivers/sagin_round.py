"""Driver of the paper's SAGIN FL round (arXiv:2408.09522 §VI): one
region's job, ``repro_torch.fl.RegionTrainer``, stepped round after round.

A round is ``RegionTrainer.step``: the NumPy control plane (the
adaptive offloading optimizer, the handover schedule, the latency
model), the bucketed cohort's host gather and copy, the vmapped local SGD
of every node that holds data, the eq.-(13) aggregate through the
``fedavg_agg`` kernel, and the held-out evaluation, whose read of the
accuracy ends the round on the host.  The rounds run back to back: a
closed loop of one job.

Set-up builds the job from the configuration's ``scenario_seed`` (the
same deployment, data and channel draws in every run) with the
benchmark's own VGG-11 weights from the seed, runs its first
``compared_rounds`` rounds (the comparison's), then the rest of
``warmup_rounds``; the window steps on.  The traced run turns on the
program's own tracer with ``device_timing`` (each bucket dispatch fenced
by a synchronize) for its window and keeps the window's
``bucket_dispatch`` spans; the profiled rounds after it run unfenced, as
an untraced window does.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from perfbench.lib import weights as W
from perfbench.reference import compare as C
from perfbench.reference import sagin as R
from perfbench.reference import vgg11 as V
from perfbench.reference.precision import exact

@dataclasses.dataclass
class State:
    ctx: object
    trainer: object = None
    p0: list = None
    first: list = None
    span: list = None
    losses: list = None
    next_round: int = 0
    shapes_warm: set = None


def _fl(ctx) -> dict:
    """The FL settings of the cell: the configuration's, with the
    traffic's strategy."""
    fl = dict(ctx.config["fl"])
    fl["strategy"] = ctx.workload["traffic"]["strategy"]
    return fl


def _scenario_seed(ctx) -> int:
    """The deployment's seed, fixed by the configuration: the dataset,
    the partition, the geometry and every round's channel draws, and so
    the plan and the bucket layout, are the same in every run; ``--seed``
    draws the VGG-11 weights.  From the seed alone, the layout (and with
    it a round's work) differed by up to a fifth between seeds."""
    return int(ctx.config.get("scenario_seed", ctx.seed))


def _precision(tf32: bool) -> None:
    """The configuration's float32: TF32 on or off for the program's
    convolutions and matrix products (PyTorch's process-wide flags)."""
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)


def build(ctx, traced=None, tf32=None) -> State:
    from repro_torch.fl import FLConfig, RegionTrainer
    from repro_torch.obs import ObsConfig
    traced = bool(traced)
    _precision(ctx.config["tf32"] if tf32 is None else tf32)
    fl = _fl(ctx)
    cfg = FLConfig(**fl, seed=_scenario_seed(ctx), n_rounds=10 ** 6,
                   device=ctx.device,
                   obs=(ObsConfig(path=None, device_timing=True,
                                  perfetto=False) if traced else None))
    params = W.vgg11(ctx.seed, ctx.device)
    st = State(ctx)
    st.p0 = [t.clone() for t in V.leaves(params)]
    st.trainer = RegionTrainer(cfg, params=params)
    return st


def _step(st: State) -> None:
    st.trainer.step(st.next_round)
    st.next_round += 1


def first_steps(st: State) -> None:
    n = st.ctx.workload["compared_rounds"]
    for r in range(n):
        _step(st)
        if r == 0:
            st.first = C.change_norms(V.leaves(st.trainer.params), st.p0)
    st.span = C.change_norms(V.leaves(st.trainer.params), st.p0)
    st.losses = list(st.trainer.result.losses[:n])
    st.p0 = None


def warm(st: State) -> None:
    while st.next_round < st.ctx.workload["warmup_rounds"]:
        _step(st)
    eng = st.trainer.cohort_engine
    st.shapes_warm = set(eng.signatures)


def window(st: State, seconds: float, traced: bool, rounds=None) -> dict:
    fl = st.ctx.config["fl"]
    tracer = st.trainer.tracer
    if tracer.enabled:
        # fence the bucket dispatches only where their spans are read
        tracer.device_timing = bool(traced)
    done = []
    t_start = time.perf_counter()
    while True:
        r = st.next_round
        t0 = time.perf_counter()
        _step(st)
        t1 = time.perf_counter()
        pools = R._node_pools(fl, st.trainer.pools)
        done.append({"round": r, "t0": t0 - t_start, "t1": t1 - t_start,
                     "pool_sizes": [len(p) for p in pools]})
        if (len(done) >= rounds if rounds else t1 - t_start >= seconds):
            break
    losses = st.trainer.result.losses[done[0]["round"]:]
    return {"rounds": done, "wall_s": done[-1]["t1"],
            "attempted": len(done),
            "failed": sum(1 for v in losses if not math.isfinite(v))}


def end_to_end(st: State, win: dict) -> dict:
    return {"round_s": win["wall_s"] / len(win["rounds"])}


def layer_data(st: State, win: dict, profiled: dict) -> dict:
    """The window's rounds (with the samples they trained) and wall, the
    program's spans of those rounds, and the profiled segment's rounds."""
    fl = st.ctx.config["fl"]
    window_rounds = {r["round"] for r in win["rounds"]}
    spans = [dataclasses.asdict(s) for s in st.trainer.tracer.spans
             if s.round in window_rounds]
    for r in win["rounds"] + profiled["rounds"]:
        r["real_samples"] = R.real_samples(
            [range(n) for n in r["pool_sizes"]], fl["h_local"],
            fl["batch_cap"])
        r["clients"] = sum(1 for n in r["pool_sizes"] if n)
    return {"rounds": win["rounds"], "wall_s": win["wall_s"],
            "profiled": profiled["rounds"], "spans": spans,
            "n_params": W.vgg11_param_count()}


def notes(st: State, win: dict) -> list:
    from repro_torch.kernels.fedavg_agg import kernel as agg
    eng = st.trainer.cohort_engine
    fresh = len(set(eng.signatures) - st.shapes_warm)
    walls = [r["t1"] - r["t0"] for r in win["rounds"]]
    return [f"bucket shapes first seen in the window: {fresh} "
            f"(warm: {len(st.shapes_warm)})",
            f"rounds in the window: {len(walls)}, walls s: "
            f"{[round(w, 4) for w in walls]}",
            f"fedavg_agg launches: {agg.weighted_aggregate.launches}",
            f"padding ratio (layout / real): "
            f"{eng.stats.padding_ratio:.4f}"]


def program_readings(st: State) -> dict:
    return {"losses": st.losses, "first": st.first, "span": st.span}


def release(st: State) -> None:
    st.trainer = None


def reference(ctx) -> dict:
    """The compared rounds in plain VGG-11 from the same weights, on the
    control plane worked out again; float32 with TF32 off."""
    n = ctx.workload["compared_rounds"]
    with exact():
        p0 = W.vgg11(ctx.seed, ctx.device)
        losses, after = R.run(p0, _fl(ctx), _scenario_seed(ctx), n,
                              ctx.device)
        before = V.leaves(p0)
        first = C.change_norms(V.leaves(after[0]), before)
        span = C.change_norms(V.leaves(after[-1]), before)
    return {"losses": losses, "first": first, "span": span}


def control(ctx) -> dict:
    """The control: the program's own lower precision switched on (TF32
    for the float32 the configuration states), its compared rounds."""
    st = build(ctx, False, tf32=True)
    first_steps(st)
    out = program_readings(st)
    release(st)
    _precision(ctx.config["tf32"])
    return out


def judge(prog: dict, ref: dict) -> dict:
    return C.readings(prog["losses"], ref["losses"], prog["first"],
                      ref["first"], prog["span"], ref["span"])
