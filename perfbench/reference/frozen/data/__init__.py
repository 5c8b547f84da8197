# Frozen copy of src/repro_torch/data/__init__.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
from .synthetic import SPECS, Dataset, make_dataset
from .partition import DevicePartition, FederatedPools, partition
from .pipeline import BatchIterator, batch_for_local_steps

__all__ = ["SPECS", "Dataset", "make_dataset", "DevicePartition",
           "FederatedPools", "partition", "BatchIterator",
           "batch_for_local_steps"]
