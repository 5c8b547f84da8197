"""Run one function on several local processes, one rank each.

A small launcher for the multi-rank paths on one host: what
``torchrun --nproc-per-node N`` does for a script, for a function.
:func:`run_ranks` spawns ``world`` processes (the ``spawn`` start
method: nothing of the parent is inherited but its ``sys.path`` and
environment), and each

1. joins a process group of ``backend`` through a ``file://`` store at
   ``init_file`` (no TCP port: several groups can start at once);
   ``"hoststage"`` (:mod:`.hoststage`, the route for ranks that share
   one card) is registered in the rank first;
2. selects ``cuda:(rank % device_count)`` when ``device`` is ``"cuda"``
   (so several ranks can share one card);
3. runs ``fn(rank, world, *args)`` and writes what it returns, pickled,
   beside the store;
4. destroys the group.

The parent waits at most ``timeout`` seconds for all of them; a rank
that raises, or a run past the timeout, stops every rank and raises in
the parent.  ``fn`` must be importable by name (a module-level function)
and return only picklable values (numpy arrays, not tensors).
"""
from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, init_file: str, args: Sequence) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend == "hoststage":
        from .hoststage import register
        register()
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(f"{init_file}.rank{rank}", "wb") as fh:
        pickle.dump(out, fh)


def run_ranks(fn: Callable, world: int, init_file, args: Sequence = (), *,
              backend: str = "gloo", device: str = "cpu",
              timeout: float = 600.0,
              while_running: Callable[[], None] = None) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    on its own spawned process in one process group (module docstring).
    ``init_file`` is a path that does not exist yet, in a directory the
    caller owns (a test's ``tmp_path``); the results are written beside
    it.  ``while_running()``, if given, runs in the parent once the ranks
    are started (its own work beside their start; what it raises stops
    them)."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA device")
    init_file = str(Path(init_file).resolve())
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file} exists: a file store needs a "
                              f"fresh path")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, backend, device, init_file,
                          tuple(args)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        if while_running is not None:
            while_running()
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran "
                                   f"past {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        for proc in ctx.processes:
            proc.join(10)
    out = []
    for rank in range(world):
        with open(f"{init_file}.rank{rank}", "rb") as fh:
            out.append(pickle.load(fh))
    return out
