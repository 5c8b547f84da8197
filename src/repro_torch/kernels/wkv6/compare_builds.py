"""Time builds of the wkv6 kernel against each other on one card.

Each argument is a ``csrc`` directory holding a ``wkv6.cu`` with this
package's C entry point (for example this package's own ``csrc``, or one
unpacked from an earlier commit with ``git archive``).  Every build runs
in a process of its own (two builds of one library do not load side by
side), in turns A, B, B, A, ..., at the shape of the
rwkv6-1.6b prefill (4x32x2048x64) in bfloat16 and float32, decays from
[0.7, 0.999], checked against the step-by-step plain version at
``chip_smoke``'s tolerances and timed from a replayed CUDA graph.  Run
from the root of a checkout, on the card:

    python -m repro_torch.kernels.wkv6.compare_builds \\
        src/repro_torch/kernels/wkv6/csrc OTHER/csrc

Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

from ..compare import graph_ms, in_turns

SHAPE = (4, 32, 2048, 64)
REPS = 10
TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}


def measure(csrc: str) -> dict:
    """Build the ``wkv6.cu`` in the directory ``csrc``, check it once per
    type and time it."""
    import torch

    from . import kernel, ref
    kernel.SOURCE = Path(csrc).resolve() / "wkv6.cu"
    kernel.build.cache_clear()
    gen = torch.Generator(device="cuda").manual_seed(0)
    base = [torch.randn(SHAPE, generator=gen, device="cuda")
            * scale for scale in (1.0, 0.3, 1.0)]
    base.append(0.7 + 0.299 * torch.rand(SHAPE, generator=gen,
                                         device="cuda"))
    base.append(0.1 * torch.randn(SHAPE[1::2], generator=gen,
                                  device="cuda"))
    out = {"build": csrc, "device": torch.cuda.get_device_name(0)}
    for dtype_name, tol in TOLERANCE.items():
        args = [x.to(getattr(torch, dtype_name)) for x in base]
        want = ref.wkv(*args).float()
        err = (kernel.wkv(*args).float() - want).abs()
        for _ in range(3):
            kernel.wkv(*args)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                kernel.wkv(*args)
        times = [graph_ms(graph, REPS) for _ in range(6)]
        out[dtype_name] = {
            "max_abs_err": float(err.max()),
            "ok": bool((err <= tol * (1 + want.abs())).all()),
            "ms": times, "median_ms": statistics.median(times)}
        del graph
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("builds", nargs="+",
                        help="csrc directories")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of A, B, ... then ..., B, A")
    parser.add_argument("--one", action="store_true",
                        help="measure the one build given, in this process")
    args = parser.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.builds[0])), flush=True)
        return 0
    return in_turns(__spec__.name, args.builds, args.rounds)


if __name__ == "__main__":
    sys.exit(main())
