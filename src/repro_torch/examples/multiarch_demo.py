"""Model-zoo demo: train + decode a reduced variant of every assigned
architecture through the same public API the launcher uses.

    PYTHONPATH=src python -m repro_torch.examples.multiarch_demo \
        [--arch qwen3-32b] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import transformer as T
from ._report import Lines, add_device


def run(arch: str, device, say, params=None):
    """3 SGD steps (lr 1e-3) on one batch of 2 x 64, then 4 greedy decode
    tokens of the first request; ``params`` (the reduced config's, in the
    port's layout) replaces the seeded init."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(0)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    b, s = 2, 64
    if cfg.input_mode == "tokens":
        inputs = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                 dtype=torch.int64, device=device)
    else:
        inputs = torch.as_tensor(rng.normal(size=(b, s, cfg.d_model)),
                                 dtype=torch.float32, device=device)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                             dtype=torch.int64, device=device)
    step = T.make_train_step(cfg, lr=1e-3, device=device)
    t0 = time.perf_counter()
    for _ in range(3):
        params, m = step(params, {"inputs": inputs, "labels": labels})
    # decode 4 tokens greedily
    cache = T.init_cache(cfg, b, 64, device=device)
    tok = inputs[:, :1]
    toks = []
    with torch.no_grad():
        for pos in range(4):
            logits, cache = T.serve_step(params, cfg, cache, tok, pos)
            nxt = torch.argmax(logits, -1)[:, None]
            toks.append(int(nxt[0, 0]))
            tok = nxt if cfg.input_mode == "tokens" else torch.zeros(
                (b, 1, cfg.d_model), dtype=torch.float32, device=device)
    loss = float(m["loss"])
    full = get_config(arch)
    say(f"{arch:24s} loss={loss:6.3f} "
        f"decoded={toks} "
        f"[full: {full.param_count()/1e9:6.1f}B params, "
        f"{full.n_layers}L] ({time.perf_counter()-t0:.1f}s)")
    return {"arch": arch, "loss": loss, "decoded": toks}


def main(argv=None, *, params=None):
    """``params``: the initial model of ``--arch``'s reduced config (one
    architecture only)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if params is not None and args.arch is None:
        raise ValueError("params= is one architecture's model: pass --arch")
    say = Lines()
    runs = [run(arch, device, say, params)
            for arch in ([args.arch] if args.arch else ARCH_IDS)]
    return {"lines": say.lines, "runs": runs}


if __name__ == "__main__":
    main()
