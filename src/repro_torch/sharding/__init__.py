"""Partition-spec tables of the model zoo and the cohort engine."""
from .specs import (PartitionSpec, batch_axes, cache_pspecs,
                    cohort_step_specs, data_axis_size, data_pspec,
                    param_pspecs)

__all__ = ["PartitionSpec", "batch_axes", "cache_pspecs",
           "cohort_step_specs", "data_axis_size", "data_pspec",
           "param_pspecs"]
