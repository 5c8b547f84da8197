"""The cells at a size a CPU test run holds: the same drivers, the same
files, with the sizes overridden (the program on the CPU runs its plain
versions where the card runs its kernels)."""
from __future__ import annotations

import copy

from perfbench.lib import harness

SAGIN = "sagin_round.vgg11.adaptive"
FL = "fl_step.rwkv6-1.6b.r4h2"


def fl_context(seed: int, device: str = "cpu") -> harness.Context:
    """The FL step's cell at its own size, as its files give it."""
    return harness.context(FL, seed, device=device)


def context(name: str, seed: int = 12345):
    ctx = harness.context(name, seed, device="cpu")
    ctx.config = copy.deepcopy(ctx.config)
    ctx.workload = copy.deepcopy(ctx.workload)
    if name == SAGIN:
        ctx.config["fl"].update(train_fraction=0.01, n_devices=5, n_air=1,
                                h_local=2, batch_cap=8, eval_size=64)
        ctx.workload.update(compared_rounds=2, warmup_rounds=3)
    elif name == FL:
        ctx.config["model"].update(n_layers=2, d_model=128, d_ff=256,
                                   vocab_size=512)
        ctx.config["param_count"] = param_count(ctx.config["model"])
        ctx.workload["traffic"].update(n_replicas=2, global_batch=4,
                                       seq_len=64, lr=0.05)
    return ctx


def param_count(m: dict) -> int:
    d, ff, n, v = m["d_model"], m["d_ff"], m["n_layers"], m["vocab_size"]
    v = ((v + 255) // 256) * 256
    hd = d // max(1, d // 64)
    per = 7 * d * d + 2 * d * ff + 5 * d + d + (d // hd) * hd + hd \
        + 2 * d + 2 * d
    return n * per + 2 * v * d + d
