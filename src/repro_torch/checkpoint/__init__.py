"""Checkpoints in the JAX package's on-disk format: parameter trees
(npz + ``.tree`` sidecar), the satellite handover blob, and full
``SAGINEngine`` snapshots that resume bit-identically."""
from .ckpt import handover_state, load_pytree, save_pytree
from .engine import restore_engine, save_engine

__all__ = ["load_pytree", "save_pytree", "handover_state",
           "restore_engine", "save_engine"]
