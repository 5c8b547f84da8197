"""Which collectives plain ``gloo`` and the ``hoststage`` backend run on
CUDA tensors, side by side.

DTensor's steps dispatch all-gathers, reduce-scatters and all-reduces
(``torch.distributed._functional_collectives``); the port's FL paths
all-reduce and broadcast too.  This probe runs each of
:data:`COLLECTIVES` on CUDA tensors over 2 ranks sharing ``cuda:0``:
over plain ``gloo``, each collective in a spawn of its own (on torch
2.11 its all-gather ended the ranks with SIGSEGV), and over
``hoststage`` (:mod:`.hoststage`, which stages every collective through
host memory), all in one spawn.  It prints one JSON line: the torch
version and, for each collective, each backend's rank-0 result or how
its ranks ended, and whether the result is the expected one.  Rerun it
after a torch upgrade::

    PYTHONPATH=src python -m repro_torch.launch.gloo_probe
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

import torch

from .spawn import run_ranks

COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_reduce_sum", "all_reduce_avg", "broadcast", "barrier",
               "all_to_all_single")
BACKENDS = ("gloo", "hoststage")


def _one(which, rank):
    """``which`` on this rank's CUDA tensor (rank r holds r + 1): what
    rank 0 gets back, as a list."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    group = dist.group.WORLD
    x = torch.full((4, 3), float(rank + 1), device="cuda")
    if which == "all_gather_into_tensor":
        y = fc.all_gather_tensor(x, 0, group)
    elif which == "reduce_scatter_tensor":
        y = fc.reduce_scatter_tensor(x, "sum", 0, group)
    elif which.startswith("all_reduce"):
        y = fc.all_reduce(x, which.split("_")[-1], group)
    elif which == "broadcast":
        dist.broadcast(x, src=1)
        y = x
    elif which == "barrier":
        dist.barrier()
        y = x
    else:
        y = fc.all_to_all_single(x, [2, 2], [2, 2], group)
    return fc.wait_tensor(y).cpu().tolist()


def _expected(which):
    """Rank 0's result of ``which`` over 2 ranks holding 1 and 2."""
    rows = {"all_gather_into_tensor": [1.0] * 4 + [2.0] * 4,
            "reduce_scatter_tensor": [3.0] * 2,
            "all_reduce_sum": [3.0] * 4, "all_reduce_avg": [1.5] * 4,
            "broadcast": [2.0] * 4, "barrier": [1.0] * 4,
            "all_to_all_single": [1.0] * 2 + [2.0] * 2}[which]
    return [[v] * 3 for v in rows]


def _rank(rank, world, collectives):
    """Each of ``collectives`` in turn: its result, or the error it
    raised (a crash ends the rank instead)."""
    out = {}
    for which in collectives:
        try:
            out[which] = {"ok": True, "rank0": _one(which, rank)}
        except Exception as exc:  # the error is the finding
            out[which] = {"ok": False,
                          "error": f"{type(exc).__name__}: {exc}"[-300:]}
    return out


def _spawn(tmp, tag, backend, collectives, timeout):
    try:
        return run_ranks(_rank, 2, Path(tmp) / tag, (collectives,),
                         backend=backend, device="cuda",
                         timeout=timeout)[0]
    except Exception as exc:  # how the ranks ended is the finding
        err = f"{type(exc).__name__}: {exc}"[-300:]
        return {which: {"ok": False, "error": err} for which in collectives}


def probe(timeout: float = 120.0) -> dict:
    """``{collective: {backend: {"ok", "rank0" or "error", "expected"}}}``
    for each of :data:`COLLECTIVES` and :data:`BACKENDS`."""
    out = {which: {} for which in COLLECTIVES}
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        for which in COLLECTIVES:
            out[which]["gloo"] = _spawn(tmp, f"gloo_{which}", "gloo",
                                        (which,), timeout)[which]
        staged = _spawn(tmp, "hoststage", "hoststage", COLLECTIVES, timeout)
        for which in COLLECTIVES:
            out[which]["hoststage"] = staged[which]
    for which, rows in out.items():
        for rec in rows.values():
            if rec["ok"]:
                rec["expected"] = rec["rank0"] == _expected(which)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__, "collectives": probe()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
