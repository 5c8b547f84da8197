"""Time builds of the wkv6 kernel against each other on one card.

Each argument is a ``csrc`` directory holding a ``wkv6.cu`` with this
package's C entry point (for example this package's own ``csrc``, or one
unpacked from an earlier commit with ``git archive``).  Every build runs
in a process of its own (two builds of one library do not load side by
side), in turns A, B, B, A, ..., at the shape of the
rwkv6-1.6b prefill (4x32x2048x64) in bfloat16 and float32, decays from
[0.7, 0.999], checked against the step-by-step plain version at
``chip_smoke``'s tolerances and timed from a replayed CUDA graph.  With
``--backward`` the same for the backward (``wkv6_bwd.cu``) at the
rwkv6-1.6b training shape (the same) in bfloat16, with decays from
[0.7, 0.999] and from [0, 0.999] with exact zeros, checked against
autograd through ``ref.wkv_chunked`` in f32 at 2e-2 x (1 + |grad|) (the
wrapper's scratch fits earlier builds' designs too).  Run from the root of a
checkout, on the card:

    python -m repro_torch.kernels.wkv6.compare_builds [--backward] \\
        src/repro_torch/kernels/wkv6/csrc OTHER/csrc

Prints one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import re
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


def measure_backward(csrc: str) -> dict:
    """Build the ``wkv6_bwd.cu`` in the directory ``csrc``, check it once
    per decay range and time it."""
    import torch

    from . import kernel, ref
    kernel.SOURCE_BWD = Path(csrc).resolve() / "wkv6_bwd.cu"
    kernel.build_backward.cache_clear()
    out = {"build": csrc, "backward": True,
           "device": torch.cuda.get_device_name(0)}
    for w_lo in (0.7, 0.0):
        gen = torch.Generator(device="cuda").manual_seed(0)
        args = [torch.randn(SHAPE, generator=gen, device="cuda") * scale
                for scale in (1.0, 0.3, 1.0)]
        w = w_lo + (0.999 - w_lo) * torch.rand(SHAPE, generator=gen,
                                               device="cuda")
        if w_lo == 0.0:
            w[:, :, ::5, ::3] = 0.0
        args += [w, 0.1 * torch.randn(SHAPE[1::2], generator=gen,
                                      device="cuda")]
        args = [x.bfloat16() for x in args]
        dout = torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
        leaves = [x.float().requires_grad_() for x in args]
        want = torch.autograd.grad(ref.wkv_chunked(*leaves, chunk=64),
                                   leaves, dout.float())
        got = kernel.wkv_backward(*args, dout)
        err = max(float((g.float() - x).abs().max())
                  for g, x in zip(got, want))
        ok = all(bool(((g.float() - x).abs()
                       <= TOLERANCE["bfloat16"] * (1 + x.abs())).all())
                 for g, x in zip(got, want))
        del leaves, want, got
        torch.cuda.empty_cache()
        for _ in range(3):
            kernel.wkv_backward(*args, dout)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                kernel.wkv_backward(*args, dout)
        times = [graph_ms(graph, REPS) for _ in range(6)]
        out[f"bfloat16-w_lo-{w_lo}"] = {
            "max_abs_err": err, "ok": ok, "ms": times,
            "median_ms": statistics.median(times),
            "kernel_ms": _by_kernel(lambda: kernel.wkv_backward(*args,
                                                                 dout))}
        del graph
    return out


def _by_kernel(fn) -> dict:
    """Device ms per call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``REPS`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+(?:<[^>]*>)?)\(", e.key)
            out[name.group(1) if name else e.key[:60]] = (
                e.device_time_total / REPS / 1e3)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("builds", nargs="+",
                        help="csrc directories")
    parser.add_argument("--rounds", type=int, default=2,
                        help="rounds of A, B, ... then ..., B, A")
    parser.add_argument("--backward", action="store_true",
                        help="time the backward instead of the forward")
    parser.add_argument("--one", action="store_true",
                        help="measure the one build given, in this process")
    args = parser.parse_args(argv)
    if args.one:
        fn = measure_backward if args.backward else measure
        print(json.dumps(fn(args.builds[0])), flush=True)
        return 0
    return in_turns(__spec__.name, args.builds, args.rounds,
                    ["--backward"] if args.backward else [])


if __name__ == "__main__":
    sys.exit(main())
