"""Federated training on PyTorch: round loop, cohort execution,
aggregation."""
from .aggregation import (aggregation_weights, client_finite_mask, fedavg,
                          fedavg_pytrees, fedavg_stacked,
                          fedavg_stacked_multi, staleness_merge_weights,
                          staleness_weighted_merge, tree_all_finite)
from .client import (cohort_local_update, cross_entropy, evaluate,
                     local_update, masked_cross_entropy, masked_local_update)
from .cohort_engine import CohortEngine, CohortEngineStats
from .rounds import FLConfig, FLResult, RegionTrainer, run_fl

__all__ = [
    "aggregation_weights", "client_finite_mask", "fedavg", "fedavg_pytrees",
    "fedavg_stacked", "fedavg_stacked_multi", "staleness_merge_weights",
    "staleness_weighted_merge", "tree_all_finite", "cohort_local_update",
    "cross_entropy", "evaluate", "local_update", "masked_cross_entropy",
    "masked_local_update", "CohortEngine", "CohortEngineStats", "FLConfig",
    "FLResult", "RegionTrainer", "run_fl",
]
