"""The readings a cell's limits are set from, many seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half_batch,answer_altered] \
        [--fault-seeds 1,2,3]

For every seed: the plain reference once, the program's compared steps
(set-up only: no window) judged against it, and where asked the control
(the reference in the precision below the configuration's, in the
program's place) and each planted fault (:mod:`perfbench.lib.faults`)
judged against the same reference.  One JSON line a reading: ``seed``,
``side`` (``program``, ``control`` or the fault) and the numbers.  The
benchmark's runs never run this; it needs the card the cell asks for.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from perfbench.lib import faults, harness  # noqa: E402


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def _program(drv, ctx):
    state = drv.build(ctx, False)
    drv.first_steps(state)
    prog = drv.program_readings(state)
    drv.release(state)
    del state
    return prog


def _free(torch, ctx):
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, type=_ints)
    ap.add_argument("--control-seeds", default=[], type=_ints)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default=[], type=_ints)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    import torch
    planted = [f for f in args.faults.split(",") if f]
    out = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        ctx = harness.context(args.workload, seed, device=device)
        drv = harness.driver(ctx)
        sides = []
        if seed in args.seeds:
            sides.append(("program", None))
        if seed in args.fault_seeds:
            sides += [(f, f) for f in planted]
        progs = {}
        for side, fault in sides:
            t0 = time.perf_counter()
            if fault is None:
                progs[side] = _program(drv, ctx)
            else:
                with faults.plant(ctx.workload["driver"], fault):
                    progs[side] = _program(drv, ctx)
            progs[side]["seconds"] = time.perf_counter() - t0
            _free(torch, ctx)
        t0 = time.perf_counter()
        ref = drv.reference(ctx)
        ref_s = time.perf_counter() - t0
        _free(torch, ctx)
        if seed in args.control_seeds:
            progs["control"] = drv.control(ctx)
            _free(torch, ctx)
        for side, prog in progs.items():
            line = {"workload": args.workload, "seed": seed, "side": side,
                    "reference_s": ref_s, "program_s": prog.get("seconds"),
                    "readings": drv.judge(prog, ref),
                    "losses": prog["losses"], "ref_losses": ref["losses"]}
            out.append(line)
            print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()
