"""The port's serving router and gateway against the reference's, on the
CPU.

Routing is NumPy arithmetic in both packages, so every ``RouteDecision``
is identical.  The gateway's admission, routing, batching and
accounting are the same code too: with the reference's trained params
carried into the port's trainers (``convert.params_from_jax``), a
session gives the same ``ServeReport`` (all but ``qps_wall``, a host
clock) and the same requests — targets, simulated latencies, waits and
correctness flags.  The gateway's own tests (config precedence, replay,
per-request dispatch, training left bit-identical, the staleness gap)
run on the port alone.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fl.rounds import FLConfig as JaxFLConfig
from repro.models import cnn as jax_cnn
from repro.scenarios import get_scenario as jax_get_scenario
from repro.serve import LinkState as JaxLinkState
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeGateway as JaxServeGateway
from repro.serve import ServeTopology as JaxServeTopology
from repro.serve import get_router as jax_get_router
from repro.sim.engine import SAGINEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.fl import FLConfig, FederationConfig
from repro_torch.scenarios import get_scenario
from repro_torch.serve import (LinkState, ServeConfig, ServeGateway,
                               ServeTopology, TransformerBackend, get_router)
from repro_torch.serve.router import GROUND_RTT, INFER_CYCLES, ROUTERS
from repro_torch.sim import SAGINEngine
from repro_torch.tree import tree_leaves

TINY = dict(dataset="mnist", n_devices=4, n_air=1, h_local=1,
            train_fraction=0.005, eval_size=64, seed=0,
            execution="sequential")


def two_region_scenario(get=get_scenario):
    base = get("multi_region")
    return dataclasses.replace(base, name="_serve_test",
                               regions=base.regions[:2])


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines():
    """The reference's 2-region engine and the port's, each trained one
    round from the reference's initial model (the same control-plane
    state: clocks, satellites, pools), then the port's trainers given
    the reference's trained params (the expensive part, shared)."""
    jeng = JaxEngine(two_region_scenario(jax_get_scenario),
                     fl=JaxFLConfig(n_rounds=1, **TINY))
    init = params_from_jax(_numpy(jeng.trainers[0].params), "cpu")
    jeng.run(1)
    eng = SAGINEngine(two_region_scenario(),
                      fl=FLConfig(n_rounds=1, device="cpu", **TINY),
                      params=init)
    eng.run(1)
    for t, jt in zip(eng.trainers, jeng.trainers):
        assert t.wall_clock == jt.wall_clock
        t.params = params_from_jax(_numpy(jt.params), "cpu")
    return jeng, eng


@pytest.fixture(scope="module")
def trained_engine():
    """One port engine trained a single round on the CPU."""
    eng = SAGINEngine(two_region_scenario(),
                      fl=FLConfig(n_rounds=1, device="cpu", **TINY))
    eng.run(1)
    return eng


# -- router -----------------------------------------------------------------
def make_topo(n=3, fast_sat=5e9):
    return ServeTopology(sat_f=[fast_sat] * n, ground_f=1e8,
                         req_bits=6272.0, z_isl=3.125e6, topology="ring")


def test_router_prefers_own_sat_when_clean():
    dec = get_router("min_rt", make_topo()).route(0, {}, {})
    assert dec.target == ("sat", 0)
    assert dec.est_response > 0


def test_router_avoids_uplink_dead_air():
    links = {0: LinkState(uplink_delay=30.0)}
    dec = get_router("min_rt", make_topo()).route(0, {}, links)
    assert dec.target == ("ground", 0)
    assert dec.network == pytest.approx(GROUND_RTT)


def test_router_spills_to_isl_neighbour_under_queue_pressure():
    dec = get_router("min_rt", make_topo()).route(0, {("sat", 0): 500}, {})
    assert dec.target in (("sat", 1), ("sat", 2))


def test_router_isl_fade_stretches_neighbour_route():
    topo = make_topo()
    clean = topo.network_time(0, ("sat", 1), {})
    faded = topo.network_time(0, ("sat", 1), {1: LinkState(isl_scale=0.1)})
    assert faded > clean


def test_static_nearest_is_blind():
    links = {0: LinkState(uplink_delay=30.0)}
    dec = get_router("static_nearest", make_topo()).route(
        0, {("sat", 0): 500}, links)
    assert dec.target == ("sat", 0)
    assert dec.est_response > 30.0      # still priced honestly


def test_service_time_hetero():
    topo = make_topo(fast_sat=3e9)
    assert topo.service_time(("sat", 0)) == pytest.approx(INFER_CYCLES / 3e9)
    assert topo.service_time(("ground", 0)) == pytest.approx(
        INFER_CYCLES / 1e8)


def test_get_router_unknown_raises():
    with pytest.raises(ValueError, match="static_nearest"):
        get_router("does_not_exist", make_topo())


@pytest.mark.parametrize("name", sorted(ROUTERS))
def test_router_decisions_match_reference(name):
    """A seeded sweep over topologies, queue depths and link states: both
    packages' routers give equal decisions."""
    rng = np.random.default_rng(11)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        sat_f = list(rng.uniform(1e9, 1e10, size=n))
        args = dict(ground_f=1e8, req_bits=float(rng.uniform(1e3, 1e5)),
                    z_isl=float(rng.uniform(1e6, 1e7)),
                    topology=str(rng.choice(["ring", "star"])))
        router = get_router(name, ServeTopology(sat_f, **args))
        jrouter = jax_get_router(name, JaxServeTopology(sat_f, **args))
        nodes = [(k, j) for j in range(n) for k in ("sat", "ground")]
        depth = {node: int(rng.integers(0, 400)) for node in nodes
                 if rng.random() < 0.5}
        states = {j: (float(rng.uniform(0.05, 1.0)),
                      float(rng.choice([0.0, rng.uniform(0.0, 40.0)])),
                      float(rng.uniform(0.1, 1.5)))
                  for j in range(n) if rng.random() < 0.6}
        links = {j: LinkState(*s) for j, s in states.items()}
        jlinks = {j: JaxLinkState(*s) for j, s in states.items()}
        origin = int(rng.integers(0, n))
        got = router.route(origin, depth, links)
        want = jrouter.route(origin, depth, jlinks)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


# -- gateway against the reference ------------------------------------------
def _requests(gw):
    return [dataclasses.astuple(r) for r in gw.completed]


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_gateway_matches_reference(engines, router):
    jeng, eng = engines
    kw = dict(base_rate=2.0, router=router)
    jgw = JaxServeGateway(jeng, serve=JaxServeConfig(**kw))
    gw = ServeGateway(eng, serve=ServeConfig(**kw))
    want = jgw.run(120.0)
    got = gw.run(120.0)
    assert got.requests > 0 and got.served == got.requests
    assert (dataclasses.asdict(dataclasses.replace(got, qps_wall=0.0))
            == dataclasses.asdict(dataclasses.replace(want, qps_wall=0.0)))
    assert _requests(gw) == _requests(jgw)
    # the per-request gather reads host copies of the eval sets
    for x, t in zip(gw._x, eng.trainers):
        assert isinstance(x, np.ndarray)
        np.testing.assert_array_equal(x, t.x_eval.numpy())


# -- the gateway's own behaviour --------------------------------------------
def test_gateway_requires_fl_engine():
    eng = SAGINEngine(two_region_scenario())      # no fl= -> no trainers
    with pytest.raises(ValueError, match="FL-mode"):
        ServeGateway(eng)


def test_gateway_end_to_end(trained_engine):
    gw = ServeGateway(trained_engine, serve=ServeConfig(base_rate=1.0))
    rep = gw.run(90.0, t0=0.0)
    assert rep.requests > 0
    assert rep.served == rep.requests             # queues fully drained
    assert all(len(q) == 0 for q in gw.queues.values())
    assert rep.latency_p99 >= rep.latency_p50 > 0
    assert 0.0 <= rep.served_accuracy <= 1.0
    assert sum(rep.count_by_target.values()) == rep.served
    assert "router=min_rt" in rep.summary()
    assert all(r.latency > 0 and r.wait >= 0 for r in gw.completed)


def test_gateway_replay_identical(trained_engine):
    """Same engine state + same serve config -> identical sessions."""
    cfg = ServeConfig(base_rate=1.0)
    r1 = ServeGateway(trained_engine, serve=cfg).run(60.0, t0=0.0)
    r2 = ServeGateway(trained_engine, serve=cfg).run(60.0, t0=0.0)
    assert (dataclasses.replace(r1, qps_wall=0.0)
            == dataclasses.replace(r2, qps_wall=0.0))


def test_gateway_config_precedence(trained_engine):
    """Argument > FLConfig.serve > Scenario.serve > defaults."""
    eng = trained_engine
    assert ServeGateway(eng).cfg == ServeConfig()  # multi_region: no serve
    arg_cfg = ServeConfig(base_rate=9.0)
    assert ServeGateway(eng, serve=arg_cfg).cfg is arg_cfg
    fl_cfg = ServeConfig(base_rate=3.0)
    eng2 = SAGINEngine(two_region_scenario(),
                       fl=FLConfig(serve=fl_cfg, device="cpu", **TINY))
    assert ServeGateway(eng2).cfg is fl_cfg
    assert ServeGateway(eng2, serve=arg_cfg).cfg is arg_cfg
    flash = SAGINEngine("flash_crowd", fl=FLConfig(device="cpu", **TINY))
    assert ServeGateway(flash).cfg == get_scenario("flash_crowd").serve


def test_gateway_per_request_dispatch_degenerate(trained_engine):
    gw = ServeGateway(trained_engine,
                      serve=ServeConfig(base_rate=1.0, max_batch=1,
                                        batch_align=1))
    rep = gw.run(30.0, t0=0.0)
    assert rep.batches == rep.served              # one dispatch per request


def test_gateway_transformer_backend(trained_engine):
    be = TransformerBackend(get_config("llama3.2-3b").reduced(
        n_layers=2, d_model=64), seq_len=8, device="cpu")
    gw = ServeGateway(trained_engine, serve=ServeConfig(base_rate=0.3),
                      backend=be)
    rep = gw.run(30.0, t0=0.0)
    assert rep.served == rep.requests > 0
    assert rep.served_accuracy is None
    assert rep.acc_by_region == {}
    assert be.last_logits is not None
    assert bool(torch.isfinite(be.last_logits).all())


def test_training_bit_identical_with_gateway_attached():
    """Serving between rounds must not perturb training: params, clocks
    and accuracy trajectories stay bit-identical (read-only contract)."""
    scn = two_region_scenario()
    fl = FLConfig(n_rounds=2, device="cpu", **TINY)
    plain = SAGINEngine(scn, fl=fl)
    plain.run(2)
    attached = SAGINEngine(scn, fl=fl)
    attached.run(1, final_merge=False)
    rep = ServeGateway(attached, serve=ServeConfig(base_rate=2.0)).run(60.0)
    assert rep.served > 0
    attached.run(1)
    for a, b in zip(plain.trainers, attached.trainers):
        assert a.result.accuracies == b.result.accuracies
        assert a.wall_clock == b.wall_clock
        for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
            assert torch.equal(x, y)


def test_staleness_served_accuracy_gap():
    """With an aggressive staleness discount, soft_async leaves regions on
    diverged models while the synchronous barrier installs one merged
    model everywhere, and the gateway serves measurably better for it
    (the reference's config, seed and initial model)."""
    init, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(1),
                                  image_shape=(28, 28, 1))
    init = params_from_jax(_numpy(init), "cpu")

    def served(policy):
        scn = dataclasses.replace(
            two_region_scenario(),
            federation=FederationConfig(policy=policy, every=1,
                                        topology="ring", half_life=30.0))
        fl = FLConfig(dataset="mnist", n_devices=4, n_air=1, h_local=2,
                      train_fraction=0.05, eval_size=256, seed=1,
                      execution="sequential", n_rounds=3, device="cpu")
        eng = SAGINEngine(scn, fl=fl, params=init)
        eng.run(3)
        return eng, ServeGateway(eng, serve=ServeConfig(
            base_rate=2.0)).run(120.0, t0=0.0)

    eng_sync, rep_sync = served("synchronous")
    eng_async, rep_async = served("soft_async")
    assert rep_sync.requests == rep_async.requests
    assert rep_sync.count_by_target == rep_async.count_by_target
    s0, s1 = (tree_leaves(t.params) for t in eng_sync.trainers)
    assert all(torch.equal(x, y) for x, y in zip(s0, s1))
    a0, a1 = (tree_leaves(t.params) for t in eng_async.trainers)
    assert any(not torch.equal(x, y) for x, y in zip(a0, a1))
    assert any(s > 0.0 for m in eng_async.merges for s in m.staleness)
    assert rep_sync.served_accuracy > rep_async.served_accuracy + 0.02
