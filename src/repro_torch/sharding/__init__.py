"""Partition-spec tables of the model zoo and the cohort engine, their
placement on a ``DeviceMesh`` (DTensor), and the activation constraints
of the sharded steps (:mod:`.activations`)."""
from .specs import (PartitionSpec, batch_axes, cache_pspecs,
                    cohort_step_specs, data_axis_size, data_pspec,
                    distribute_cache, distribute_params, param_pspecs,
                    placements)

__all__ = ["PartitionSpec", "batch_axes", "cache_pspecs",
           "cohort_step_specs", "data_axis_size", "data_pspec",
           "distribute_cache", "distribute_params", "param_pspecs",
           "placements"]
