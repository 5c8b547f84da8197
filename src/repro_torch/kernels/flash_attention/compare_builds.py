"""Time builds of the flash_attention kernel against each other on one card.

Each argument is a ``csrc`` directory holding a ``flash_attention.cu``
with the C entry point of this package's kernel (for example this
package's own ``csrc``, or one unpacked from an earlier commit with
``git archive``).  Every build runs in a process of its own (two builds
of one library do not load side by side), in turns A, B, B, A, ..., at
the bf16 shape of the llama3.2-3b prefill (q 4x24x2048x128, 8 kv heads,
causal), checked against the plain version at 1e-2 x (1 + |out|) and
timed from a replayed CUDA graph beside ``scaled_dot_product_attention``
in the same process.  Run from the root of a checkout, on the card:

    python -m repro_torch.kernels.flash_attention.compare_builds \\
        src/repro_torch/kernels/flash_attention/csrc OTHER/csrc

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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csrc", nargs="+", type=Path)
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of A, B, ... then ..., B, A")
    parser.add_argument("--one", action="store_true",
                        help="measure the one build given, in this process")
    args = parser.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.csrc[0])), flush=True)
        return 0
    return in_turns(__spec__.name, [str(b) for b in args.csrc], args.rounds)


if __name__ == "__main__":
    sys.exit(main())
