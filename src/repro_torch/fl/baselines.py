"""The paper's comparison schemes (Section VI-A) as executable
data-placement policies.

Every scheme name maps to an orchestrator strategy hook (a
``(orchestrator, round) -> OffloadPlan`` callable registered in
``repro_torch.core.strategies``) rather than a bare string; model aggregation
is FedAvg (eq. 13) in every scheme, as in the paper.

- ``none``         : no data offloading (space/air only aggregate).
- ``air_ground``   : offloading only between air and ground layers.
- ``ground_space`` : offloading only between ground and space (air relays).
- ``static``       : adaptive optimization at round 0 only, then frozen.
- ``proportional`` : samples proportional to each node's compute power.
- ``adaptive``     : the proposed method.

Run ``PYTHONPATH=src python -m repro_torch.fl.baselines`` for a quick
all-schemes latency comparison on the paper topology.
"""
from __future__ import annotations

from typing import Dict, List

from ..core.strategies import StrategyFn, resolve_strategy

BASELINES = ["none", "air_ground", "ground_space", "static", "proportional"]
ALL_SCHEMES = BASELINES + ["adaptive"]

#: scheme name -> data-placement policy hook for ``SAGINOrchestrator``
#: (resolve_strategy raises at import time if a scheme lacks a policy)
SCHEME_HOOKS: Dict[str, StrategyFn] = {
    name: resolve_strategy(name) for name in ALL_SCHEMES
}


def run_scheme(name: str, n_rounds: int = 3, n_devices: int = 8,
               n_air: int = 2, seed: int = 0, **orch_kwargs) -> List:
    """Run one scheme's orchestration for a few rounds; returns the
    per-round :class:`~repro_torch.core.scheduler.RoundRecord` list."""
    from ..core import SAGINOrchestrator, build_default_sagin

    sagin = build_default_sagin(n_devices=n_devices, n_air=n_air, seed=seed)
    orch = SAGINOrchestrator(sagin, strategy=name, sat_f_seed=seed,
                             **orch_kwargs)
    return orch.run(n_rounds)


def compare_schemes(n_rounds: int = 3, n_devices: int = 8, n_air: int = 2,
                    seed: int = 0) -> Dict[str, List[float]]:
    """Per-round realized latencies of every scheme on the same topology."""
    return {name: [r.realized_latency
                   for r in run_scheme(name, n_rounds, n_devices, n_air,
                                       seed)]
            for name in ALL_SCHEMES}


def main() -> None:
    import numpy as np
    lats = compare_schemes()
    print(f"{'scheme':>14s}  mean round latency (s)")
    for name in ALL_SCHEMES:
        print(f"{name:>14s}  {np.mean(lats[name]):10.1f}")


if __name__ == "__main__":
    main()
