"""``repro_torch`` — the SAGIN federated-learning system on PyTorch and CUDA.

The PyTorch counterpart of the JAX package ``repro``, module for module:
``repro_torch/fl/rounds.py`` mirrors ``repro/fl/rounds.py``.  The NumPy
control plane (``core``, ``data``, ``obs``) is a copy of the reference's;
the models, the client update, the aggregation and the round loop are
rewritten in PyTorch, and the eq.-(13) aggregate runs through a CUDA
kernel written for Hopper (``kernels/fedavg_agg``).

Entry points run on the device named by ``FLConfig.device`` (``"cuda"``
by default) and raise when CUDA is asked for and absent; pass
``device="cpu"`` to run on the CPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
