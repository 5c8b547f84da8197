"""``repro_torch.serve`` — request-driven serving over the port's SAGIN FL
stack.

Turn a scenario's dynamics into inference traffic and route it the way
the paper routes data:

    from repro_torch.fl import FLConfig
    from repro_torch.serve import ServeConfig, ServeGateway
    from repro_torch.sim import SAGINEngine

    engine = SAGINEngine("multi_region", fl=FLConfig(...))
    engine.run(4)                       # train a few rounds
    gw = ServeGateway(engine, serve=ServeConfig(base_rate=2.0))
    report = gw.run(duration=600.0)     # serve 10 simulated minutes
    print(report.summary())

or ``python -m repro_torch.serve --scenario multi_region`` for the CLI.
See the module docstrings of :mod:`~repro_torch.serve.workload`
(arrivals), :mod:`~repro_torch.serve.router` (offloading decision),
:mod:`~repro_torch.serve.gateway` (batched dispatch + accounting) and
:mod:`~repro_torch.serve.backends` (the models that answer).
"""
from .backends import CNNBackend, TransformerBackend  # noqa: F401
from .gateway import ServeGateway, ServeReport, resolve_serve  # noqa: F401
from .router import (LinkState, MinResponseTimeRouter, ROUTERS,  # noqa: F401
                     RouteDecision, ServeTopology, StaticNearestRouter,
                     get_router)
from .workload import (Request, RegionWorkload, ServeConfig,  # noqa: F401
                       serve_rng)

__all__ = [
    "CNNBackend", "TransformerBackend",
    "ServeGateway", "ServeReport", "resolve_serve",
    "LinkState", "MinResponseTimeRouter", "ROUTERS", "RouteDecision",
    "ServeTopology", "StaticNearestRouter", "get_router",
    "Request", "RegionWorkload", "ServeConfig", "serve_rng",
]
