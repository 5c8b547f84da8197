"""The control at each cell's own size, on the card, must come out not
correct under the cell's limits, on three seeds: for the SAGIN round the
program with its own lower precision switched on (TF32 under the
configuration's float32), for the FL step the plain reference with its
matrix products in fp8 (below the configuration's bf16).

Card only: ``python -m pytest -q -m cuda perfbench/tests`` on the chip
(about ten minutes: each seed runs the reference twice at full size).
"""
import pytest

from perfbench.lib import harness

SEEDS = (2147483659, 3000000123, 4000000007)
CELLS = [c["name"] for c in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run at full size")
    harness.cache_dirs()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    ctx = harness.context(cell, seed)
    drv = harness.driver(ctx)
    ref = drv.reference(ctx)
    got = drv.judge(drv.control(ctx), ref)
    limits = ctx.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), got
