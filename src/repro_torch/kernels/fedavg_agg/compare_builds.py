"""Time builds of the fedavg_agg kernel against each other on one card.

Each argument is a ``csrc`` directory holding a ``fedavg_agg.cu`` with
this package's C entry point (for example this package's own ``csrc``,
or one unpacked from an earlier commit with ``git archive``).  Every
build runs in a process of its own (two builds of one library do not
load side by side), in turns A, B, B, A, ..., on the paper setup's MNIST
round aggregate (8 leaves over buckets of 64 + 4 clients, one launch)
and VGG-11's flat parameter buffer (68 x 9,225,610), in float32 and
bfloat16, each checked against the plain version and timed from a
replayed CUDA graph beside ``torch.tensordot`` (one a leaf) in the same
process.  Run from the root of a checkout, on the card:

    python -m repro_torch.kernels.fedavg_agg.compare_builds \\
        src/repro_torch/kernels/fedavg_agg/csrc OTHER/csrc

Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

from ..compare import graph_ms, in_turns

SPLIT = (64, 4)
VGG11_PARAMS = 9_225_610
REPS = 20
TOLERANCE = {"float32": 1e-6, "bfloat16": 2e-2}


def _graph(fn, torch):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    return graph


def measure(csrc: Path) -> dict:
    """Build ``csrc``; check and time each case beside ``tensordot``."""
    import torch

    from . import kernel, ref
    from ...models.cnn import build_model
    from ...tree import tree_leaves
    kernel.SOURCE = csrc.resolve() / "fedavg_agg.cu"
    kernel.build.cache_clear()
    params, _ = build_model("mnist", 0, torch.device("cpu"))
    shapes = {"mnist_round": [tuple(t.shape) for t in tree_leaves(params)],
              "vgg11": [(VGG11_PARAMS,)]}
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.rand(sum(SPLIT), generator=gen, device="cuda") + 0.1
    w = w / w.sum()
    out = {"csrc": str(csrc), "device": torch.cuda.get_device_name(0)}
    for case, leaves in shapes.items():
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            parts = [[torch.randn((c,) + s, generator=gen,
                                  device="cuda").to(dtype) for s in leaves]
                     for c in SPLIT]
            stacks = [torch.cat(x) for x in zip(*parts)]
            w_lib = w.to(dtype)
            errs = [((a.float() - b.float()).abs()
                     <= tol * (1 + b.float().abs())).all()
                    for a, b in zip(kernel.aggregate(parts, w),
                                    ref.aggregate(parts, w))]
            graphs = {
                "kernel": _graph(lambda: kernel.aggregate(parts, w), torch),
                "tensordot": _graph(lambda: [torch.tensordot(w_lib, x, 1)
                                             for x in stacks], torch)}
            times = {name: [] for name in graphs}
            for order in (("kernel", "tensordot"),
                          ("tensordot", "kernel")) * 3:
                for name in order:
                    times[name].append(graph_ms(graphs[name], REPS))
            out[f"{case}_{dtype_name}"] = {
                "ok": bool(all(errs)),
                **{f"{k}_ms": statistics.median(v) for k, v in times.items()}}
            del graphs, parts, stacks
    return out


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
    return in_turns(__spec__.name, [str(c) for c in args.csrc], args.rounds)


if __name__ == "__main__":
    sys.exit(main())
