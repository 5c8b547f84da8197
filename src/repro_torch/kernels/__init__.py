"""Hand-written Hopper kernels of the port, one package per kernel.

Each keeps the reference's three-part split: ``kernel`` (the CUDA kernel
and its wrapper), ``ops`` (dispatch by the tensor's device) and ``ref``
(the plain PyTorch version).  Kernels are compiled from the sources in
``csrc/`` at first use; nothing here builds or loads anything at import.
"""
