"""Time builds of the flash_attention kernels against each other on one card.

Each argument is a ``csrc`` directory holding a ``flash_attention.cu``
with the C entry point of this package's kernel (for example this
package's own ``csrc``, or one unpacked from an earlier commit with
``git archive``).  Every build runs in a process of its own (two builds
of one library do not load side by side), in turns A, B, B, A, ..., at
the bf16 shape of the llama3.2-3b prefill (q 4x24x2048x128, 8 kv heads,
causal), checked against the plain version at 1e-2 x (1 + |out|) and
timed from a replayed CUDA graph beside ``scaled_dot_product_attention``
in the same process.  With ``--backward`` the same for the backward
(``flash_attention_bwd.cu``) at the llama3.2-3b training shape (the
same), from the plain forward's output and log-sum-exp (so every build
gets the same inputs; a build from before the forward wrote the
log-sum-exp recomputes it, in its time), checked against autograd
through the plain version in f32 at 2e-2 x (1 + |grad|) and timed beside
``scaled_dot_product_attention``'s backward (eager calls, CUDA events).
Run from the root of a checkout, on the card:

    python -m repro_torch.kernels.flash_attention.compare_builds \\
        [--backward] src/repro_torch/kernels/flash_attention/csrc OTHER/csrc

Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..compare import graph_ms, in_turns

SHAPE, KV_HEADS = (4, 24, 2048, 128), 8
REPS = 10


def _event_ms(fn, reps: int) -> float:
    """Per-call ms of ``reps`` eager calls of ``fn``, from CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(csrc: Path) -> dict:
    """Build ``csrc``, check it once and time it beside SDPA, in turns."""
    import torch
    import torch.nn.functional as F

    from . import kernel, ref
    kernel.SOURCE = csrc.resolve() / "flash_attention.cu"
    kernel.build.cache_clear()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, s, d = SHAPE
    q = torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, KV_HEADS, s, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    want = ref.attention(q, k, v).float()
    err = (kernel.flash_attention(q, k, v).float() - want).abs()
    fns = {"kernel": lambda: kernel.flash_attention(q, k, v),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)}
    graphs = {}
    for name, fn in fns.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(REPS):
                fn()
    times = {name: [] for name in fns}
    for order in (("kernel", "sdpa"), ("sdpa", "kernel")) * 3:
        for name in order:
            times[name].append(graph_ms(graphs[name], REPS))
    return {"csrc": str(csrc), "device": torch.cuda.get_device_name(0),
            "max_abs_err": float(err.max()),
            "ok": bool((err <= 1e-2 * (1 + want.abs())).all()),
            "kernel_ms": times["kernel"], "sdpa_ms": times["sdpa"]}


def measure_backward(csrc: Path) -> dict:
    """Build ``csrc``'s backward, check it once and time it beside SDPA's
    backward, in turns."""
    import torch
    import torch.nn.functional as F

    from . import kernel, ref
    kernel.SOURCE_BWD = csrc.resolve() / "flash_attention_bwd.cu"
    kernel.build_backward.cache_clear()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, hq, s, d = SHAPE
    q = torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, KV_HEADS, s, d), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    dout = torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
    o, lse = ref.attention(q, k, v), ref.row_lse(q, k)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*leaves), leaves,
                               dout.float())
    got = kernel.flash_attention_backward(q, k, v, o, lse, dout)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    ok = all(bool(((g.float() - w).abs() <= 2e-2 * (1 + w.abs())).all())
             for g, w in zip(got, want))
    del leaves, want, got
    torch.cuda.empty_cache()
    sdpa_leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*sdpa_leaves, is_causal=True,
                                              enable_gqa=True)
    fns = {"kernel": lambda: kernel.flash_attention_backward(
               q, k, v, o, lse, dout),
           "sdpa": lambda: torch.autograd.grad(sdpa_out, sdpa_leaves, dout,
                                               retain_graph=True)}
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fns["kernel"]()
    times = {"kernel": [], "kernel_eager": [], "sdpa": []}
    for order in (("kernel", "sdpa"), ("sdpa", "kernel")) * 3:
        for name in order:
            if name == "kernel":
                times["kernel"].append(graph_ms(graph, REPS))
                times["kernel_eager"].append(_event_ms(fns["kernel"], REPS))
            else:
                times["sdpa"].append(_event_ms(fns["sdpa"], REPS))
    return {"csrc": str(csrc), "backward": True,
            "device": torch.cuda.get_device_name(0), "max_abs_err": err,
            "ok": ok, "kernel_ms": times["kernel"],
            "kernel_eager_ms": times["kernel_eager"],
            "sdpa_backward_ms": times["sdpa"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csrc", nargs="+", type=Path)
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of A, B, ... then ..., B, A")
    parser.add_argument("--backward", action="store_true",
                        help="time the backward instead of the forward")
    parser.add_argument("--one", action="store_true",
                        help="measure the one build given, in this process")
    args = parser.parse_args(argv)
    if args.one:
        fn = measure_backward if args.backward else measure
        print(json.dumps(fn(args.csrc[0])), flush=True)
        return 0
    return in_turns(__spec__.name, [str(b) for b in args.csrc], args.rounds,
                    ["--backward"] if args.backward else [])


if __name__ == "__main__":
    sys.exit(main())
