"""Model-execution backends of the serving path and the request workload
(arrival processes and ``ServeConfig``, which scenarios carry); the
gateway and router come with the serving slice, ROADMAP.md §1."""
from .backends import CNNBackend, TransformerBackend
from .workload import Request, RegionWorkload, ServeConfig, serve_rng

__all__ = ["CNNBackend", "TransformerBackend", "Request", "RegionWorkload",
           "ServeConfig", "serve_rng"]
