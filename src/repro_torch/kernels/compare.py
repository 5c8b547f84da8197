"""What the kernels' ``compare_builds`` modules share: CUDA-graph timing
and running each build in a process of its own, in turns (two builds of
one library do not load side by side)."""
from __future__ import annotations

import subprocess
import sys
from typing import Sequence


def graph_ms(graph, reps: int) -> float:
    """Per-call ms of one replay of ``graph``, which holds ``reps`` calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(module: str, builds: Sequence[str], rounds: int,
             extra: Sequence[str] = ()) -> int:
    """``python -m module --one BUILD *extra`` for each build, in turns
    A, B, ... then ..., B, A; the exit codes or-ed."""
    order = []
    for r in range(rounds):
        order += list(builds) if r % 2 == 0 else list(builds)[::-1]
    rc = 0
    for build in order:
        rc |= subprocess.run([sys.executable, "-m", module, "--one", build,
                              *extra]).returncode
    return rc
