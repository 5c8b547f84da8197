"""Which collectives DTensor dispatches that ``gloo`` can run on CUDA tensors.

A split tensor makes DTensor dispatch an all-gather and a reduce-scatter
(``torch.distributed._functional_collectives``).  This probe runs each on
CUDA tensors over 2 ``gloo`` ranks sharing ``cuda:0``, each collective in
its own spawn, and prints one JSON line: the torch version and, for each
collective, rank 0's result or how the ranks ended.  On torch 2.11 the
all-gather ended its ranks with SIGSEGV, so no DTensor step runs on two
ranks of one card; rerun it after a torch upgrade::

    PYTHONPATH=src python -m repro_torch.launch.gloo_probe
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch

from .spawn import run_ranks

COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor")


def _rank(rank, world, which):
    """One collective on a CUDA tensor: what this rank gets back."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    x = torch.full((4, 3), float(rank + 1), device="cuda")
    if which == "all_gather_into_tensor":
        y = fc.all_gather_tensor(x, 0, dist.group.WORLD)
    else:
        y = fc.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)
    return fc.wait_tensor(y).cpu().tolist()


def probe(timeout: float = 120.0) -> dict:
    """{collective: {"ok": True, "rank0": value} or {"ok": False,
    "error": ...}} for each of :data:`COLLECTIVES`."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        for which in COLLECTIVES:
            try:
                got = run_ranks(_rank, 2, Path(tmp) / which, (which,),
                                backend="gloo", device="cuda",
                                timeout=timeout)[0]
                out[which] = {"ok": True, "rank0": got}
            except Exception as exc:  # how the ranks ended is the finding
                out[which] = {"ok": False,
                              "error": f"{type(exc).__name__}: {exc}"[-300:]}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__, **probe()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
