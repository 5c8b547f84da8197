"""Driver of the transformer FL train step:
``repro_torch.launch.train.make_fl_train_step`` on one card, every
replica in its slot (``mesh=None``).

A round is one ``fl_round``: each of ``n_replicas`` replicas takes
``h_local`` SGD steps on its own rows (forward, remat, backward through
the hand-written kernels), then the eq.-(13) mean over the replicas'
float32 stacks goes through the ``fedavg_agg`` kernel and back into every
slot.  Every round ends in ``torch.cuda.synchronize()``.  The rows are
random tokens drawn on the card from the seed, new rows every round.

Set-up makes the weights on the card from the seed, builds the step, and
runs its first ``compared_rounds`` rounds (the comparison's, which also
warm up every shape the window uses); the window steps on.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from perfbench.lib import weights as W
from perfbench.reference import compare as C
from perfbench.reference import rwkv6 as R
from perfbench.reference.precision import exact

CONTROL = "fp8"


@dataclasses.dataclass
class State:
    ctx: object
    step: object = None
    params_rep: dict = None
    p0: list = None
    gen: object = None
    first: list = None
    span: list = None
    losses: list = None
    slot_gap: float = 0.0


def _shape(ctx):
    t = ctx.workload["traffic"]
    return (t["n_replicas"], t["global_batch"] // t["n_replicas"],
            t["seq_len"])


def _batch(ctx, gen):
    n_rep, rows, seq = _shape(ctx)
    return W.token_batch(gen, ctx.config["model"]["vocab_size"],
                         (n_rep, rows), seq, ctx.device)


def _stack(params, n: int):
    """Every leaf with a leading replica axis of ``n`` equal slots."""
    return R.rebuild(params, [t.unsqueeze(0).expand(n, *t.shape).clone()
                              for t in R.leaves(params)])


def build(ctx, traced=None) -> State:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.train import make_fl_train_step
    t = ctx.workload["traffic"]
    cfg = ModelConfig(**ctx.config["model"])
    shape = InputShape("fl_step", t["seq_len"], t["global_batch"], "train")
    st = State(ctx)
    st.step = make_fl_train_step(cfg, t["n_replicas"], shape, lr=t["lr"],
                                 h_local=t["h_local"],
                                 agg_dtype=t["agg_dtype"],
                                 device=ctx.device)
    params = W.rwkv6(ctx.config["model"], ctx.seed, ctx.device)
    st.p0 = R.leaves(params)
    st.params_rep = _stack(params, t["n_replicas"])
    st.gen = W.generator(ctx.seed, ctx.device, stream=1)
    return st


def _round(st: State):
    st.params_rep, metrics = st.step(st.params_rep, _batch(st.ctx, st.gen))
    return metrics


def _slot_gap(params_rep) -> float:
    """The largest difference between any slot and slot 0."""
    return max(float((x - x[:1]).abs().max()) for x in
               R.leaves(params_rep))


def first_steps(st: State) -> None:
    st.losses = []
    for r in range(st.ctx.workload["compared_rounds"]):
        metrics = _round(st)
        st.losses.append(float(metrics["loss"]))
        st.slot_gap = max(st.slot_gap, _slot_gap(st.params_rep))
        now = [x[0] for x in R.leaves(st.params_rep)]
        if r == 0:
            st.first = C.change_norms(now, st.p0)
    st.span = C.change_norms(now, st.p0)
    st.p0 = None


def _sync(ctx) -> None:
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()


def warm(st: State) -> None:
    _sync(st.ctx)


def window(st: State, seconds: float, traced: bool, rounds=None) -> dict:
    done, losses = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        metrics = _round(st)
        _sync(st.ctx)
        t1 = time.perf_counter()
        losses.append(metrics["loss"])
        done.append({"t0": t0 - t_start, "t1": t1 - t_start})
        if (len(done) >= rounds if rounds else t1 - t_start >= seconds):
            break
    losses = [float(v) for v in losses]
    return {"rounds": done, "wall_s": done[-1]["t1"],
            "attempted": len(done),
            "failed": sum(1 for v in losses if not math.isfinite(v)),
            "losses": losses}


def tokens_per_round(ctx) -> int:
    t = ctx.workload["traffic"]
    return t["h_local"] * t["global_batch"] * t["seq_len"]


def end_to_end(st: State, win: dict) -> dict:
    return {"fl_tokens_per_s": tokens_per_round(st.ctx)
            * len(win["rounds"]) / win["wall_s"]}


def layer_data(st: State, win: dict, profiled: dict) -> dict:
    return {"rounds": win["rounds"], "wall_s": win["wall_s"],
            "tokens": tokens_per_round(st.ctx) * len(win["rounds"]),
            "profiled": profiled["rounds"]}


def notes(st: State, win: dict) -> list:
    from repro_torch.kernels.fedavg_agg import kernel as agg
    from repro_torch.kernels.wkv6 import kernel as wkv
    walls = [r["t1"] - r["t0"] for r in win["rounds"]]
    return [f"rounds in the window: {len(walls)}, walls s: "
            f"{[round(w, 4) for w in walls]}",
            f"losses: {[round(v, 5) for v in win['losses']]}",
            f"launches: fedavg_agg {agg.weighted_aggregate.launches}, "
            f"wkv6 {wkv.wkv.launches}, wkv6 backward "
            f"{wkv.wkv_backward.launches}"]


def program_readings(st: State) -> dict:
    return {"losses": st.losses, "first": st.first, "span": st.span,
            "slot_gap": st.slot_gap}


def release(st: State) -> None:
    st.step = st.params_rep = st.gen = None


def reference(ctx, precision=None) -> dict:
    """The compared rounds in the plain model from the same weights and
    rows; float32 with TF32 off, or with its products in ``precision``
    (the control's)."""
    t = ctx.workload["traffic"]
    with exact():
        params = W.rwkv6(ctx.config["model"], ctx.seed, ctx.device)
        p0 = [x.clone() for x in R.leaves(params)]
        gen = W.generator(ctx.seed, ctx.device, stream=1)
        losses = []
        for r in range(ctx.workload["compared_rounds"]):
            params, value = R.fl_round(params, _batch(ctx, gen), t["lr"],
                                       t["h_local"], precision)
            losses.append(value)
            if r == 0:
                first = C.change_norms(R.leaves(params), p0)
        span = C.change_norms(R.leaves(params), p0)
    return {"losses": losses, "first": first, "span": span,
            "names": R.paths(params),
            "dtypes": [str(x.dtype) for x in p0]}


def control(ctx) -> dict:
    """The control: the reference with its matrix products in fp8, the
    precision below the configuration's bf16, in the program's place."""
    return reference(ctx, CONTROL)


def judge(prog: dict, ref: dict) -> dict:
    exact = [i for i, t in enumerate(ref["dtypes"]) if t == "torch.float32"]
    out = C.readings(prog["losses"], ref["losses"], prog["first"],
                     ref["first"], prog["span"], ref["span"], exact)
    out["slot_gap"] = prog.get("slot_gap", 0.0)
    return out
