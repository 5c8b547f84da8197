"""End-to-end example (deliverable b): federated training of the paper's
MNIST CNN over a Walker-Star constellation for a few hundred rounds,
comparing the adaptive scheme against the no-offloading baseline, on the
card (``--device cpu`` on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.sagin_fl_end2end [--rounds N]

Reduced defaults keep the run short; raise --rounds/--devices and
--fraction for the paper-scale experiment.

Scenario registry
-----------------
Pass ``--scenario <name>`` to run against a named preset from
``repro_torch.scenarios`` instead of the bare paper constellation, e.g.

    PYTHONPATH=src python -m repro_torch.examples.sagin_fl_end2end \
        --scenario degraded_links --rounds 50

selects the paper topology under ISL fades + weather, ``device_churn``
adds unreliable ground devices, ``mega_constellation`` swaps in a
1080-satellite shell, and ``multi_region`` spans four continents over a
shared constellation.  ``--list-scenarios`` prints every registered
preset.  Wall-clock/latency axes then reflect the *realized*
(dynamics-priced) round latencies, not just the analytic plan.

Multi-region modes
------------------
``--all-regions`` trains one INDEPENDENT model per region.
``--global-model`` instead event-steps every region through
``SAGINEngine`` and merges the region models into ONE global model over
the inter-satellite links under a pluggable federation policy
(``repro_torch.fl.federation``): ``--policy`` selects ``synchronous``
barrier merges, FedMeld-style ``soft_async`` dispersal, ``partial``
quorum merges under ISL outages, or ``elected_hub`` aggregation;
``--merge-every N`` overrides the cadence (0 disables merging).
Example:

    PYTHONPATH=src python -m repro_torch.examples.sagin_fl_end2end \
        --scenario multi_region --global-model --rounds 20 \
        --policy soft_async

Observability
-------------
``--trace PATH`` records the run with ``repro_torch.obs``: a
``repro-trace/1`` JSONL file plus a Perfetto sibling (``PATH`` with
``.perfetto.json``) that renders one timeline track per region in
https://ui.perfetto.dev.  Summarize with ``python -m repro_torch.obs
report PATH``.  Pair with ``--execution batched`` to also capture
per-bucket dispatch spans.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

from ..device import resolve_device
from ..fl import FLConfig, run_fl
from ..scenarios import get_scenario, list_scenarios
from ._report import Lines, add_device


def summarize(say, tag, res, rounds):
    best = max(res.accuracies)
    tta = res.time_to_accuracy(0.8)
    say(f"[{tag:>14s}] {rounds} rounds | "
        f"training time {res.times[-1]:9.0f} s | "
        f"best acc {best:.3f} | "
        f"time-to-80% {'%.0f s' % tta if tta else 'not reached'}")


def _parser():
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--air", type=int, default=2)
    ap.add_argument("--fraction", type=float, default=0.02)
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--constellation", action="store_true",
                    help="drive coverage windows from Walker-Star geometry")
    ap.add_argument("--scenario", default=None,
                    help="named preset from repro_torch.scenarios "
                         "(see --list-scenarios)")
    ap.add_argument("--all-regions", action="store_true",
                    help="with a multi-region scenario: train one "
                         "INDEPENDENT FL model per region over the shared "
                         "constellation")
    ap.add_argument("--global-model", action="store_true",
                    help="with a multi-region scenario: merge region "
                         "models into ONE global model over the ISLs at "
                         "the scenario's merge cadence")
    ap.add_argument("--merge-every", type=int, default=None,
                    help="override the scenario's merge cadence in rounds "
                         "(0 disables merging)")
    ap.add_argument("--policy", default=None,
                    help="federation policy for --global-model: "
                         "synchronous | soft_async | partial | elected_hub "
                         "(default: the scenario's; see "
                         "repro_torch.fl.federation)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a repro_torch.obs trace (JSONL + Perfetto "
                         "sibling) of the run to PATH; inspect with "
                         "`python -m repro_torch.obs report PATH`")
    ap.add_argument("--execution", default="auto",
                    choices=["auto", "batched", "sequential"],
                    help="round execution mode (FLConfig.execution; auto: "
                         "batched on the card, sequential on the CPU); "
                         "batched emits bucket_dispatch trace spans")
    ap.add_argument("--cohort-sharding", default="auto",
                    choices=["auto", "mesh", "off"],
                    help="shard the batched engine's bucket client axis "
                         "over the ranks of a torch.distributed group "
                         "(FLConfig.cohort_sharding): mesh needs a group "
                         "already launched, one process a device (e.g. "
                         "torchrun); this example starts none; auto shards "
                         "exactly when a group of more than one rank is up")
    ap.add_argument("--list-scenarios", action="store_true")
    add_device(ap)
    return ap


def main(argv=None, *, params=None):
    args = _parser().parse_args(argv)
    say = Lines()
    out = {"lines": say.lines, "results": {}, "merges": []}

    if args.list_scenarios:
        for name in list_scenarios():
            say(f"{name:>20s}  {get_scenario(name).description}")
        return out
    resolve_device(args.device)

    common = dict(dataset=args.dataset, iid=not args.noniid,
                  n_rounds=args.rounds, n_devices=args.devices,
                  n_air=args.air, train_fraction=args.fraction,
                  h_local=3, eval_size=1024,
                  use_constellation=args.constellation,
                  scenario=args.scenario, execution=args.execution,
                  cohort_sharding=args.cohort_sharding, obs=args.trace,
                  device=args.device)

    if args.scenario and args.global_model:
        from ..fl.federation import FederationConfig
        from ..sim import SAGINEngine
        scn = get_scenario(args.scenario)
        if args.merge_every is not None or args.policy:
            fed = scn.resolved_federation() or FederationConfig(every=2)
            if args.merge_every is not None:
                fed = (None if args.merge_every == 0 else
                       dataclasses.replace(fed, every=args.merge_every))
            if args.policy and fed is not None:
                fed = dataclasses.replace(fed, policy=args.policy)
            # also null the deprecated merge_* fields: resolved_federation
            # would resurrect them when fed is None (--merge-every 0 on a
            # legacy scenario must really disable merging)
            scn = dataclasses.replace(scn, federation=fed,
                                      merge_every=None)
        eng = SAGINEngine(scn, fl=FLConfig(strategy="adaptive", **common),
                          params=params)
        eng.run(args.rounds)
        for region, res in eng.fl_results.items():
            summarize(say, region, res, args.rounds)
            out["results"][region] = res
        for m in eng.merges:
            accs = [a for a in m.accuracies if not math.isnan(a)]
            say(f"   {m.policy:>11s} merge @ round {m.barrier_round:>3d} "
                f"t={m.time:9.0f} s"
                f" | hub {m.hub} | {len(m.participants)} region(s)"
                f" | max staleness {max(m.staleness):7.1f} s"
                f" | isl cost {max(m.isl_costs):6.1f} s"
                f" | global acc {max(accs):.3f}")
        out["merges"] = list(eng.merges)
        if eng.global_params is None:
            say("   (merging disabled: independent per-region models)")
        return out

    if args.scenario and args.all_regions:
        from ..sim import run_fl_all_regions
        results = run_fl_all_regions(FLConfig(strategy="adaptive", **common),
                                     args.scenario, params=params)
        for region, res in results.items():
            summarize(say, region, res, args.rounds)
        out["results"] = results
        return out

    for strategy in ("adaptive", "none"):
        cfg = FLConfig(strategy=strategy, **common)
        if args.trace:
            # one trace per compared run (the flush is a full rewrite,
            # so sharing a path would keep only the last strategy)
            stem, dot, ext = args.trace.rpartition(".")
            per = (f"{stem}.{strategy}.{ext}" if dot
                   else f"{args.trace}.{strategy}")
            cfg = dataclasses.replace(cfg, obs=per)
        res = run_fl(cfg, params=params)
        summarize(say, strategy, res, args.rounds)
        out["results"][strategy] = res
        if strategy == "adaptive":
            p = res.layer_portions[-1]
            say(f"            final placement ground/air/space: "
                f"{p['ground']:.0%}/{p['air']:.0%}/{p['space']:.0%}; "
                f"cases used: {sorted(set(res.cases))}")
    return out


if __name__ == "__main__":
    main()
