"""The plain references against the port, the result line, the control
and the planted faults, at a size a CPU test run holds (:mod:`.tiny`).

On the CPU the port runs its plain versions where the card runs its
kernels, and both sides compute in float32 (the transformer's config is
made float32 here), so the gaps are the order of sums alone: at most
1e-5 on losses, 1e-3 on a leaf's first change and 5e-3 on its change
over the compared rounds (the worst of VGG-11's 18 leaves read 9.2e-5
and 2.6e-4).  The
FL step's control (the reference's products in fp8) and every fault must
read at least 3x the sound program's worst gap, and a fault must turn
``correct`` false under the cell's own limits.
"""
import time

import pytest

from perfbench.lib import faults, harness
from perfbench.tests import tiny

SOUND = {"loss_gap": 1e-5, "first_change_gap": 1e-3,
         "span_change_gap": 5e-3}
CELLS = (tiny.SAGIN, tiny.FL)


def _ctx(cell):
    ctx = tiny.context(cell)
    if cell == tiny.FL:
        ctx.config["model"]["param_dtype"] = "float32"
    return ctx


def _program(drv, ctx):
    st = drv.build(ctx, False)
    drv.first_steps(st)
    return drv.program_readings(st)


@pytest.fixture(scope="module", params=CELLS)
def cell(request):
    ctx = _ctx(request.param)
    drv = harness.driver(ctx)
    ref = drv.reference(ctx)
    return ctx, drv, ref, drv.judge(_program(drv, ctx), ref)


def test_reference_agrees_with_the_port(cell):
    _, _, _, got = cell
    for key, limit in SOUND.items():
        assert got[key] <= limit, (key, got)
    assert got.get("slot_gap", 0.0) == 0.0
    assert got["leaves_kept"] == got["leaves"]


def test_control_separates(cell):
    """The FL step's control (the reference's products in fp8) runs on
    the CPU too; the SAGIN round's (the program's TF32) exists only on
    the card, where ``test_perfbench_control_cuda.py`` runs it."""
    ctx, drv, ref, sound = cell
    if ctx.workload["driver"] == "sagin_round":
        pytest.skip("the control is TF32, which only the card has")
    ctl = drv.judge(drv.control(ctx), ref)
    assert max(ctl[k] / max(sound[k], 1e-12) for k in SOUND) >= 3.0, ctl


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_turns_correct_false(cell, fault):
    ctx, drv, ref, sound = cell
    with faults.plant(ctx.workload["driver"], fault):
        got = drv.judge(_program(drv, ctx), ref)
    limits = ctx.workload["limits"]
    assert any(got[k] > limits[k] for k in limits), got
    assert max(got[k] / max(sound[k], 1e-12) for k in SOUND) >= 3.0


@pytest.mark.parametrize("scale", (1.0, 3.0), ids=("mild", "to-zero"))
def test_wkv_chunked_matches_the_scan(scale):
    """The reference's chunked recurrence against the step-by-step one in
    float64, forward and every gradient, with decays down to exp(-8000)
    (``scale`` 3)."""
    import torch
    from perfbench.reference import wkv
    g = torch.Generator().manual_seed(0)
    b, h, t, d = 1, 2, 256, 16
    r, k, v = (torch.randn(b, h, t, d, generator=g, dtype=torch.float64)
               for _ in range(3))
    lw = -torch.exp(scale * torch.randn(b, h, t, d, generator=g,
                                        dtype=torch.float64) - 2)
    u = 0.3 * torch.randn(h, d, generator=g, dtype=torch.float64)
    do = torch.randn(b, h, t, d, generator=g, dtype=torch.float64)

    def run(fn, dt):
        xs = [x.to(dt).clone().requires_grad_() for x in (r, k, v, lw, u)]
        out = fn(*xs)
        (out.double() * do).sum().backward()
        return [out.detach().double()] + [x.grad.double() for x in xs]

    want = run(wkv.wkv_scan, torch.float64)
    for got, ref in zip(run(wkv.wkv_chunked, torch.float32), want):
        assert float((got - ref).abs().max() / ref.abs().max()) < 2e-5


@pytest.mark.parametrize("traced", (False, True), ids=("untraced", "traced"))
@pytest.mark.parametrize("name", [c["name"] for c in
                                  harness.benchmark()["workloads"]])
def test_result_line(name, traced):
    """A whole run but the look for a card: the line's keys in order,
    the checks last, the metrics those of the cell and the mode."""
    ctx = _ctx(name)
    res = harness.run(ctx, 0.2, traced, time.perf_counter())
    line = res["line"]
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if traced else ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = harness.benchmark()
    e2e = [m["name"] for m in bench["end_to_end"]
           if harness.applies(m, name)]
    if traced:
        layer = {m["name"] for m in bench["per_layer"]
                 if harness.applies(m, name, e2e)}
        assert set(line["metrics"]) <= layer and line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(e2e)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
