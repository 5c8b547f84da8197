"""Vectorized SAGIN dynamics simulator: propagation (NumPy, or torch on
the card), stochastic network events, and the event-stepped multi-region
engine (network-only or full hierarchical FL with cross-region
merging)."""
from .dynamics import DynamicsConfig, NetworkDynamics, RoundEvents
from .engine import (MergeEvent, RegionTrace, SAGINEngine, region_seed,
                     region_streams, run_fl_all_regions)
from .propagation import (Region, access_intervals_loop,
                          access_intervals_multi, access_intervals_vec,
                          coverage_dot_threshold, positions_eci_batch,
                          sin_elevations, targets_eci_batch, visibility)

__all__ = ["DynamicsConfig", "NetworkDynamics", "RoundEvents", "MergeEvent",
           "RegionTrace", "SAGINEngine", "region_seed", "region_streams",
           "run_fl_all_regions", "Region", "access_intervals_loop",
           "access_intervals_multi", "access_intervals_vec",
           "coverage_dot_threshold", "positions_eci_batch",
           "sin_elevations", "targets_eci_batch", "visibility"]
