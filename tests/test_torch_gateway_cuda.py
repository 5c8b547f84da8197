"""The serving gateway on the card against the same session on the CPU.

Marked ``cuda``: it skips where no CUDA device is present.  It imports
no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gateway_cuda.py
"""
import copy
import dataclasses

import pytest
import torch

from repro_torch.fl import FLConfig
from repro_torch.scenarios import get_scenario
from repro_torch.serve import ServeConfig, ServeGateway
from repro_torch.sim import SAGINEngine
from repro_torch.tree import tree_map

TINY = dict(dataset="mnist", n_devices=4, n_air=1, h_local=1,
            train_fraction=0.005, eval_size=64, seed=0,
            execution="sequential")


def two_region_scenario():
    base = get_scenario("multi_region")
    return dataclasses.replace(base, name="_serve_test",
                               regions=base.regions[:2])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the gateway's card path needs one")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gateway_on_the_card_matches_the_cpu(cuda_device):
    """The same models answering on the card and on the CPU: identical
    routing and latencies, accuracy within 4/served (argmax near-ties)."""
    cpu = SAGINEngine(two_region_scenario(),
                      fl=FLConfig(n_rounds=1, device="cpu", **TINY))
    cpu.run(1)
    card = SAGINEngine(two_region_scenario(),
                       fl=FLConfig(n_rounds=1, device=str(cuda_device),
                                   **TINY))
    for t, src in zip(card.trainers, cpu.trainers):
        t.params = tree_map(lambda v: v.to(cuda_device), src.params)
        t.orch.wall_clock = src.wall_clock
        t.sagin.satellites = copy.deepcopy(src.sagin.satellites)
    cfg = ServeConfig(base_rate=2.0)
    got_gw = ServeGateway(card, serve=cfg)
    want_gw = ServeGateway(cpu, serve=cfg)
    got, want = got_gw.run(120.0), want_gw.run(120.0)
    assert got.requests == want.requests > 0
    assert got.count_by_target == want.count_by_target
    assert ([(r.target, r.latency) for r in got_gw.completed]
            == [(r.target, r.latency) for r in want_gw.completed])
    assert abs(got.served_accuracy - want.served_accuracy) <= 4 / got.served
