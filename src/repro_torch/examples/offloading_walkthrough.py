"""Walkthrough of the paper's analytics on a single round:
constellation -> coverage windows -> handover schedule -> offloading plan.

    PYTHONPATH=src python -m repro_torch.examples.offloading_walkthrough \
        [--device cpu]

The coverage windows are propagated on ``--device`` (float64, the same
windows as the NumPy pass); the rest is the NumPy control plane.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import (WalkerStar, build_default_sagin, optimize_offloading,
                    serving_sequence, space_schedule)
from ..core.network import Satellite
from ..device import resolve_device
from ..sim.propagation import access_intervals_vec
from ._report import Lines, add_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    say = Lines()

    # 1. constellation + coverage (replaces MATLAB walkerStar)
    ws = WalkerStar()  # 80 sats, 5 planes, 800 km, 85 deg
    ivs = access_intervals_vec(ws, t_end=4 * 3600.0, backend="torch",
                               device=args.device)
    say(f"coverage windows in 4h over (40N, 86W): {len(ivs)}")
    chain = serving_sequence(ivs, t0=0.0, max_sats=5)
    for iv in chain:
        say(f"  sat {iv.sat:2d} serves [{iv.start:6.0f}, {iv.end:6.0f}] s"
            f"  ({iv.duration/60:.1f} min)")

    # 2. a SAGIN round with those windows
    rng = np.random.default_rng(0)
    sagin = build_default_sagin(n_devices=10, n_air=2, seed=0)
    sagin.satellites = [
        Satellite(iv.sat, f=float(rng.uniform(1e9, 1e10)),
                  coverage_end=iv.end) for iv in chain]
    plan = optimize_offloading(sagin)
    say(f"\ncase {plan.case} plan: round latency "
        f"{plan.round_latency:.0f} s (baseline {plan.baseline_latency:.0f} s)")
    for cp in plan.clusters:
        moves = []
        if cp.d_space_air > 0:
            moves.append(f"sat->air {cp.d_space_air:.0f}")
        if cp.d_air_space > 0:
            moves.append(f"air->sat {cp.d_air_space:.0f}")
        if cp.d_ground_air:
            moves.append(f"ground->air {sum(cp.d_ground_air.values()):.0f}")
        if cp.d_air_ground:
            moves.append(f"air->ground {sum(cp.d_air_ground.values()):.0f}")
        say(f"  cluster {cp.n}: {', '.join(moves) or 'no transfer'}"
            f"  (latency {cp.latency:.0f} s)")

    # 3. the space-layer handover schedule for the plan (eqs. 8-12)
    sch = space_schedule(plan.new_sat_samples, sagin)
    say(f"\nspace layer processes {plan.new_sat_samples:.0f} samples "
        f"with {sch.n_handovers} handover(s):")
    for leg in sch.legs:
        say(f"  sat {leg.sat_index:2d}: start {leg.start_time:7.0f} s "
            f"(handover {leg.handover_delay:5.1f} s), "
            f"{leg.samples_processed:7.0f} samples, "
            f"ends {leg.end_time:7.0f} s")
    return {"lines": say.lines, "intervals": ivs, "chain": chain,
            "plan": plan}


if __name__ == "__main__":
    main()
