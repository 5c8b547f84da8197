"""Batched serving demo: greedy decode with the production serve path.

Runs a reduced architecture through prefill (one ``serve_step`` a prompt
position) and then batched one-token decode steps against the same
cache structure the mesh serve step shards (``launch/serve.py``), i.e.
the real serving code path, minus the mesh.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo \
        --arch deepseek-v2-lite-16b [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..launch.serve import make_serve_step
from ..models import transformer as T
from ._report import Lines, add_device


def _synced(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def main(argv=None, *, params=None):
    """``params``: the initial model of ``--arch``'s reduced config."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    add_device(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    say = Lines()

    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(0)
    if params is None:
        params = T.init_params(cfg, seed=0, device=device)
    b, p_len = args.batch, args.prompt_len
    cache_len = p_len + args.gen

    if cfg.input_mode == "tokens":
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, p_len)),
                                 dtype=torch.int64, device=device)
    else:
        prompt = torch.as_tensor(rng.normal(size=(b, p_len, cfg.d_model)),
                                 dtype=torch.float32, device=device)

    step = make_serve_step(cfg, device)
    cache = T.init_cache(cfg, b, cache_len, device=device)

    # prefill via repeated decode (the decode-vs-prefill tests hold this
    # to the teacher-forced forward)
    t0 = _synced(device)
    logits = None
    for i in range(p_len):
        logits, cache = step(params, cache, prompt[:, i:i + 1], i)
    say(f"[{args.arch}] prefilled {p_len} tokens in "
        f"{_synced(device)-t0:.2f}s")

    # greedy generation
    out = []
    tok = torch.argmax(logits, -1)[:, None]
    t0 = _synced(device)
    for i in range(p_len, cache_len):
        inp = tok if cfg.input_mode == "tokens" else torch.zeros(
            (b, 1, cfg.d_model), dtype=torch.float32, device=device)
        logits, cache = step(params, cache, inp, i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok[:, 0])
    dt = _synced(device) - t0
    gen = torch.stack(out, 1).cpu().numpy()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    say(f"generated {args.gen} tokens x batch {b} in {dt:.2f}s "
        f"({args.gen * b / dt:.1f} tok/s on {where})")
    say("sequences:")
    for r in range(b):
        say(f"   {gen[r].tolist()}")
    return {"lines": say.lines, "sequences": gen.tolist(),
            "tokens_per_s": args.gen * b / dt, "device": where}


if __name__ == "__main__":
    main()
