"""Quickstart: one adaptive-offloading round + a few FL rounds, end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

from ..core import build_default_sagin, optimize_offloading
from ..core.latency import round_latency_no_offload
from ..device import resolve_device
from ..fl import FLConfig, run_fl
from ._report import Lines, add_device


def main(argv=None, *, params=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    say = Lines()

    # --- 1. the paper's core: one adaptive data-offloading decision -------
    sagin = build_default_sagin(n_devices=10, n_air=2, seed=0)
    baseline = round_latency_no_offload(sagin)
    plan = optimize_offloading(sagin)
    say(f"round latency without offloading : {baseline:10.0f} s")
    say(f"round latency with adaptive plan : {plan.round_latency:10.0f} s"
        f"  (case {plan.case}, {baseline / plan.round_latency:.1f}x faster)")
    g, a, s = plan.new_sizes(sagin)
    total = sum(g) + sum(a) + s
    say(f"data placement  ground/air/space : "
        f"{sum(g)/total:.0%} / {sum(a)/total:.0%} / {s/total:.0%}")

    # --- 2. a short federated training run with the orchestrator ----------
    cfg = FLConfig(dataset="mnist", n_rounds=4, n_devices=10, n_air=2,
                   h_local=3, train_fraction=0.02, eval_size=512,
                   strategy="adaptive", device=args.device)
    res = run_fl(cfg, params=params)
    say("\nFL run (adaptive offloading):")
    for r, (t, acc) in enumerate(zip(res.times, res.accuracies)):
        say(f"  round {r}: training time {t:8.0f} s   accuracy {acc:.3f}")
    return {"lines": say.lines, "baseline": baseline, "plan": plan,
            "result": res}


if __name__ == "__main__":
    main()
