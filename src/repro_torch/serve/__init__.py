"""Model-execution backends of the serving path (the gateway, router and
workload come with the serving slice, ROADMAP.md §1)."""
from .backends import CNNBackend, TransformerBackend

__all__ = ["CNNBackend", "TransformerBackend"]
