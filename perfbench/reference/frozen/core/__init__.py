# Frozen copy of src/repro_torch/core/__init__.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""Core contribution of the paper: SAGIN FL orchestration.

Latency model (eqs. 5-19), Walker-Star constellation + coverage windows,
satellite data/model handover (eqs. 7-12), adaptive offloading optimizer
(Algorithms 1-2), round orchestrator, and the Theorem-1 bound.
"""
from .network import (SAGIN, AirNode, ChannelModel, GroundDevice, Satellite,
                      build_default_sagin)
from .constellation import WalkerStar, access_intervals, serving_sequence
from .handover import SpaceSchedule, space_latency, space_schedule
from .offloading import (ClusterPlan, OffloadPlan, evaluate_plan,
                         optimize_offloading)
from .scheduler import RoundRecord, SAGINOrchestrator
from .strategies import STRATEGIES, register_strategy, resolve_strategy
from .convergence import ConvergenceConfig, max_learning_rate, theorem1_bound

__all__ = [
    "SAGIN", "AirNode", "ChannelModel", "GroundDevice", "Satellite",
    "build_default_sagin", "WalkerStar", "access_intervals",
    "serving_sequence", "SpaceSchedule", "space_latency", "space_schedule",
    "ClusterPlan", "OffloadPlan", "evaluate_plan", "optimize_offloading",
    "RoundRecord", "SAGINOrchestrator", "STRATEGIES", "register_strategy",
    "resolve_strategy", "ConvergenceConfig", "max_learning_rate",
    "theorem1_bound",
]
