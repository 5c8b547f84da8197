from .synthetic import SPECS, Dataset, make_dataset
from .partition import DevicePartition, FederatedPools, partition
from .pipeline import BatchIterator, batch_for_local_steps

__all__ = ["SPECS", "Dataset", "make_dataset", "DevicePartition",
           "FederatedPools", "partition", "BatchIterator",
           "batch_for_local_steps"]
