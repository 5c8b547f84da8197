"""CLI: train a few rounds on a scenario, then serve traffic against it.

    python -m repro_torch.serve --scenario multi_region --rounds 2 \
        --duration 600 --router min_rt --trace serve.jsonl

Prints the gateway's :class:`~repro_torch.serve.gateway.ServeReport`
summary plus a per-region served-accuracy table; ``--trace`` writes the
shared training+serving JSONL trace (inspect with ``python -m
repro_torch.obs report``).  ``--device`` (default ``cuda``) is where the
models train and answer; without a card pass ``--device cpu``.  Exit
code 0 on a completed session, 2 on bad arguments.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--scenario", default="multi_region")
    ap.add_argument("--rounds", type=int, default=2,
                    help="FL training rounds before serving")
    ap.add_argument("--duration", type=float, default=600.0,
                    help="simulated seconds of serving traffic")
    ap.add_argument("--router", default=None,
                    help="override the scenario's router "
                         "(min_rt | static_nearest)")
    ap.add_argument("--backend", default="cnn",
                    choices=("cnn", "transformer"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-devices", type=int, default=6)
    ap.add_argument("--train-fraction", type=float, default=0.01)
    ap.add_argument("--trace", default=None,
                    help="JSONL trace path (training + serving spans)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (cuda | cpu)")
    args = ap.parse_args(argv)

    from ..fl.rounds import FLConfig
    from ..scenarios import get_scenario
    from ..sim.engine import SAGINEngine
    from .gateway import ServeGateway, resolve_serve

    try:
        scn = get_scenario(args.scenario)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2

    fl = FLConfig(n_devices=args.n_devices, n_air=1, h_local=1,
                  train_fraction=args.train_fraction, eval_size=256,
                  execution="sequential", seed=args.seed, obs=args.trace,
                  device=args.device)
    engine = SAGINEngine(scn, fl=fl)
    print(f"# training {args.rounds} round(s) on {scn.name} "
          f"({len(scn.regions)} region(s))", flush=True)
    engine.run(args.rounds)

    serve = resolve_serve(fl.serve if fl.serve is not None else scn.serve)
    if args.router is not None:
        serve = dataclasses.replace(serve, router=args.router)
    backend = None
    if args.backend == "transformer":
        from .backends import TransformerBackend
        backend = TransformerBackend(device=args.device)
    try:
        gw = ServeGateway(engine, serve=serve, backend=backend)
    except ValueError as e:          # e.g. an unknown --router name
        print(e, file=sys.stderr)
        return 2
    print(f"# serving {args.duration:.0f} simulated seconds "
          f"(router={serve.router}, backend={args.backend})", flush=True)
    report = gw.run(args.duration)
    print(report.summary())
    for name, acc in sorted(report.acc_by_region.items()):
        print(f"  {name}: served_acc={acc:.3f}")
    if args.trace:
        print(f"# trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
