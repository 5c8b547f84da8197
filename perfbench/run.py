"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Sets the cell up from ``--seed``, measures for ``--seconds``, checks what
the measured path produced against the plain reference, and prints one
JSON line last (``--trace 1``: the per-layer metrics from a profile of
the window).  Needs the CUDA devices the cell asks for; without them it
exits non-zero and prints no result.
"""
import os
import sys
import time


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (Linux); the
    interpreter's own start-up is set-up too."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))

from perfbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T0))
