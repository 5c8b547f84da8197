"""The port's ``SAGINEngine`` against the reference's, on the CPU.

Network-only mode is NumPy in both packages, so the event order and
every latency are identical.  In FL mode both engines start from the
reference's initial model (carried over with ``convert.params_from_jax``)
and the control plane is the same code, so the event order, every
``MergeEvent``'s time, weights, staleness, ISL costs and membership,
the realized latencies and the fault and quarantine counts are
identical; accuracies agree within 4/eval_size and the global model
after the first merge within 1e-5.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.fl import FLConfig as JaxFLConfig
from repro.fl import federation as JF
from repro.fl import rounds as JR
from repro.models import cnn as jax_cnn
from repro.obs import ObsConfig as JaxObsConfig
from repro.scenarios import Scenario as JaxScenario
from repro.sim import Region as JaxRegion
from repro.sim import SAGINEngine as JaxEngine
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl import CohortEngine, FLConfig, FederationConfig
from repro_torch.fl import rounds as R
from repro_torch.obs import ObsConfig
from repro_torch.resilience import FAULT_KINDS
from repro_torch.scenarios import Scenario, get_scenario
from repro_torch.sim import Region, SAGINEngine
from repro_torch.tree import tree_leaves

TINY = dict(dataset="mnist", n_devices=4, n_air=1, h_local=2,
            train_fraction=0.005, eval_size=64, seed=0)
PRESETS = ["paper", "mega_constellation", "multi_region", "degraded_links",
           "device_churn", "flash_crowd", "chaos"]


def _xr2(pkg_scenario, pkg_region, fed):
    """The reference tests' two-region merge scenario (unregistered)."""
    return pkg_scenario(
        name="_xr2", description="two-region merge test scenario",
        regions=(pkg_region("indiana", 40.0, -86.0),
                 pkg_region("nairobi", -1.3, 36.8)),
        n_devices=4, n_air=1,
        federation=fed(policy="synchronous", every=1, topology="star",
                       half_life=600.0),
        horizon=6 * 3600.0)


@pytest.fixture(scope="module")
def init():
    params, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(0),
                                    image_shape=(28, 28, 1))
    return jax.tree_util.tree_map(np.asarray, params)


def _merge_fields(ev):
    return (ev.barrier_round, ev.time, ev.staleness, ev.weights,
            ev.isl_costs, ev.policy, ev.hub, ev.participants, ev.recipients)


def _max_err(port_params, jax_params):
    return max(float(np.abs(a - np.asarray(b)).max()) for a, b in zip(
        tree_leaves(params_to_numpy(port_params)),
        jax.tree_util.tree_leaves(jax_params)))


@pytest.mark.parametrize("name", PRESETS)
def test_network_only_engine_matches_reference(name):
    got = SAGINEngine(name, seed=2)
    want = JaxEngine(name, seed=2)
    got.run(3)
    want.run(3)
    assert got.step_order == want.step_order
    for a, b in zip(got.traces, want.traces):
        assert a.latencies == b.latencies
        assert a.realized_latencies == b.realized_latencies
    assert got.summary() == want.summary()


def test_fl_engine_matches_reference_merge_by_merge(init):
    jeng = JaxEngine(_xr2(JaxScenario, JaxRegion, JF.FederationConfig),
                     fl=JaxFLConfig(**TINY))
    eng = SAGINEngine(_xr2(Scenario, Region, FederationConfig),
                      fl=FLConfig(device="cpu", **TINY),
                      params=params_from_jax(init, "cpu"))
    order, jorder = [], []
    for seg in range(2):
        eng.run(1)
        jeng.run(1)
        order += eng.step_order
        jorder += jeng.step_order
        if seg == 0:
            # the first merge, one round from one init: the global model
            assert _max_err(eng.global_params, jeng.global_params) <= 1e-5
            # every recipient holds its own copy of the merged model
            a, b = (tree_leaves(t.params) for t in eng.trainers)
            assert all(x is not y and x.data_ptr() != y.data_ptr()
                       for x, y in zip(a, b))
    assert order == jorder == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert len(eng.merges) == len(jeng.merges) == 2
    for got, want in zip(eng.merges, jeng.merges):
        assert _merge_fields(got) == _merge_fields(want)
        np.testing.assert_allclose(got.accuracies, want.accuracies,
                                   atol=4 / TINY["eval_size"])
    for name, res in eng.fl_results.items():
        want = jeng.fl_results[name]
        assert res.times == want.times
        assert res.latencies == want.latencies
        assert res.cases == want.cases
        np.testing.assert_allclose(res.accuracies, want.accuracies,
                                   atol=4 / TINY["eval_size"])


def _quarantined(engine):
    return engine.tracer.metrics.counter("quarantine.updates").value


def test_chaos_faults_latencies_and_quarantine_match_reference(init):
    kw = dict(TINY, n_devices=5, eval_size=32)
    jeng = JaxEngine("chaos", fl=JaxFLConfig(obs=JaxObsConfig(), **kw))
    eng = SAGINEngine("chaos", fl=FLConfig(device="cpu", obs=ObsConfig(),
                                           **kw),
                      params=params_from_jax(init, "cpu"))
    jeng.run(6)
    eng.run(6)
    inj, jinj = eng.fault_injector, jeng.fault_injector
    assert inj.injected == jinj.injected
    assert inj.recovered == jinj.recovered
    assert all(inj.injected[k] > 0 for k in FAULT_KINDS)
    assert _quarantined(eng) == _quarantined(jeng) > 0
    assert eng.step_order == jeng.step_order
    assert ([_merge_fields(m) for m in eng.merges]
            == [_merge_fields(m) for m in jeng.merges])
    for name, res in eng.fl_results.items():
        want = jeng.fl_results[name]
        assert res.latencies == want.latencies
        assert res.times == want.times
        assert res.participated == want.participated
        for loss, part in zip(res.losses, res.participated):
            assert not part or math.isfinite(loss)
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(eng.global_params))


@pytest.fixture(scope="module")
def one_region(init):
    """A reference trainer and the port's at one config: the same data,
    pools and node order (NumPy), and the reference's initial model."""
    jcfg = JaxFLConfig(execution="sequential", **TINY)
    jtr = JR.RegionTrainer(jcfg)
    tr = R.RegionTrainer(FLConfig(device="cpu", **TINY),
                         params=params_from_jax(init, "cpu"))
    nodes = R._node_pools(tr.cfg, tr.pools)
    assert len(nodes) >= 3
    return jcfg, jtr, tr, nodes


@pytest.mark.parametrize("execution", ["sequential", "batched"])
@pytest.mark.parametrize("corrupt", [(0, 2), "all"])
def test_quarantine_matches_reference(one_region, execution, corrupt):
    """NaN-filled updates are dropped and the eq.-(13) weights
    renormalize over the survivors, in both of the port's modes, as in
    the reference's sequential loop; with every update dropped the
    round keeps the previous model."""
    jcfg, jtr, tr, nodes = one_region
    if corrupt == "all":
        corrupt = tuple(range(len(nodes)))
    total = tr.pools.total()
    want, jlosses, jn = JR._round_sequential(
        jcfg, jtr.apply_fn, jtr.params, jtr.ds, nodes, total,
        np.random.default_rng(9), corrupt=corrupt, quarantine=True)
    cfg = dataclasses.replace(tr.cfg, execution=execution)
    if execution == "sequential":
        got, losses, n = R._round_sequential(
            cfg, tr.apply_fn, tr.params, tr.ds, nodes, total,
            np.random.default_rng(9), tr.device, corrupt=corrupt,
            quarantine=True)
    else:
        engine = CohortEngine(tr.apply_fn, device="cpu")
        got, losses, n = R._round_batched(
            cfg, tr.apply_fn, tr.params, tr.ds, nodes, total,
            np.random.default_rng(9), engine, corrupt=corrupt,
            quarantine=True)
    assert n == jn == len(corrupt)
    assert len(losses) == len(jlosses) == len(nodes) - len(corrupt)
    np.testing.assert_allclose(losses, jlosses, atol=1e-3)
    assert _max_err(got, want) <= 1e-5
    if len(corrupt) == len(nodes):
        assert got is tr.params


@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_trains_on_the_torch_backend(name):
    """FL mode on every preset with propagation on a torch device (the
    CPU here): the windows equal NumPy's, and two rounds train to a
    finite model in every region."""
    eng = SAGINEngine(name, backend="torch",
                      fl=FLConfig(device="cpu", n_devices=3, n_air=1,
                                  h_local=1, train_fraction=0.003,
                                  eval_size=32))
    scn = get_scenario(name)
    want = scn.build_intervals()
    assert {k: [(i.sat, i.start, i.end) for i in v]
            for k, v in eng.intervals.items()} \
        == {k: [(i.sat, i.start, i.end) for i in v]
            for k, v in want.items()}
    eng.run(2)
    assert sorted(eng.step_order) == [(i, r) for i in range(len(scn.regions))
                                      for r in range(2)]
    for t in eng.trainers:
        assert t.x_eval.device.type == "cpu"
        assert all(bool(torch.isfinite(p).all())
                   for p in tree_leaves(t.params))
    merging = scn.resolved_federation() is not None
    assert (eng.global_params is not None) == merging
    assert bool(eng.merges) == merging


def test_fl_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SAGINEngine("multi_region", fl=FLConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        SAGINEngine("paper", backend="torch")
