"""The client-sharded cohort engine on several ``gloo`` ranks, on the CPU.

The port's ``CohortEngine(sharding="mesh")`` runs SPMD, one spawned
process a shard (``repro_torch.launch.spawn.run_ranks``, a ``file://``
store under ``tmp_path``).  It is held to the reference's
``CohortEngine(sharding="off")`` run in this process: the MLP and pools
of ``tests/test_mesh_cohort.py`` (pools of 8 x 30 samples plus one of
660), 4 rounds on 2 and 4 ranks, params and losses within the
reference's own tolerance (rtol 1e-5, atol 1e-6: only the float32
reduction order differs), and with ``guard=True`` one round signature.
Also: the shard imbalance against the reference's NumPy
``_shard_real_elements`` on the same cohort; the spans' ``shard_real``;
a faulted round against the port's single-device engine (bit for bit:
it runs the same code on every rank); a 1-rank mesh bit-identical to
``"off"``; and ``RegionTrainer`` at a reduced paper setup with
``cohort_sharding="mesh"`` on 2 ranks against the reference's batched
``"off"`` trainer, each round from the reference's params before it
(accuracies within 4/eval_size, params within 1e-4), with one trace,
rank 0's.  Each world size spawns once, in a module-scoped fixture; the
reference's (JAX) side runs here, the workers import only the port.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.launch.spawn import run_ranks

ROUNDS = 4
LR = 0.1
COMMON = dict(dataset="mnist", n_rounds=2, train_fraction=0.005,
              n_devices=4, n_air=1, h_local=2, eval_size=64, seed=3)


def _data(n=900, din=32, nc=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, din)).astype(np.float32)
    y = rng.integers(0, nc, size=n)
    return x, y


def _pools(n, k_small, small):
    pools = [np.arange(k * small, (k + 1) * small) for k in range(k_small)]
    pools.append(np.arange(k_small * small, n))
    return pools


POOLS = _pools(900, 8, 30)
TOTAL = sum(len(p) for p in POOLS)


def _mlp_apply(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def _numpy(tree):
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the ranks' side: imports only the port
# ---------------------------------------------------------------------------
def _sharded_run(rank, world, init):
    """4 guarded rounds on the mesh over every rank, then one faulted
    round beside the port's single-device engine."""
    from repro_torch.fl.cohort_engine import CohortEngine
    from repro_torch.obs import ObsConfig, Tracer
    torch.set_num_threads(1)
    x, y = _data()
    tracer = Tracer(ObsConfig(path=None))
    eng = CohortEngine(_mlp_apply, batch_align=8, client_align=4,
                       device="cpu", sharding="mesh", guard=True,
                       tracer=tracer)
    params = _torch(init)
    rounds, imbalance = [], []
    for r in range(ROUNDS):
        c = eng.build(x, y, POOLS, 3, np.random.default_rng(10 + r),
                      max_batch=16)
        params, losses = eng.round(params, c, LR, TOTAL)
        rounds.append((_numpy(params), losses))
        imbalance.append(eng.stats.last_shard_imbalance)
    spans = [dict(s.attrs) for s in tracer.spans
             if s.kind == "bucket_dispatch"]
    stats = dataclasses.asdict(eng.stats)
    # a faulted round: every rank runs the single-device path over the
    # whole cohort, the code of a single-device engine on the same layout
    off = CohortEngine(_mlp_apply, batch_align=8, client_align=4,
                       device="cpu", sharding="off")
    c = eng.build(x, y, POOLS, 3, np.random.default_rng(99), max_batch=16)
    p_mesh, l_mesh = eng.round(params, c, LR, TOTAL, corrupt=(0,),
                               quarantine=True)
    p_off, l_off = off.round(params, c, LR, TOTAL, corrupt=(0,),
                             quarantine=True)
    return dict(shards=eng.shards, rounds=rounds, imbalance=imbalance,
                stats=stats,
                round_signatures=len(eng.round_signatures), spans=spans,
                faulted=dict(mesh=(_numpy(p_mesh), l_mesh,
                                   eng.last_quarantined),
                             off=(_numpy(p_off), l_off,
                                  off.last_quarantined)))


def _one_rank_mesh(init):
    """``sharding="mesh"`` over a 1-rank mesh against ``"off"``, the
    golden degrade lock of ``tests/test_mesh_cohort.py``."""
    from repro_torch.fl.cohort_engine import CohortEngine
    from repro_torch.launch.mesh import make_cohort_mesh, make_host_mesh
    from repro_torch.sharding import data_axis_size
    mesh = make_cohort_mesh(1, device="cpu")    # collective: every rank
    host = make_host_mesh(device="cpu")
    if torch.distributed.get_rank() != 0:
        return None
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.shape) == (1, 1) and data_axis_size(host) == 1
    x, y = _data(n=900, seed=5)
    pools = _pools(900, 6, 40)
    total = sum(len(p) for p in pools)
    e_off = CohortEngine(_mlp_apply, batch_align=8, client_align=4,
                         device="cpu", sharding="off")
    e_one = CohortEngine(_mlp_apply, batch_align=8, client_align=4,
                         device="cpu", sharding="mesh", mesh=mesh)
    p_off, p_one = _torch(init), _torch(init)
    out = []
    for r in range(3):
        c_off = e_off.build(x, y, pools, 3, np.random.default_rng(50 + r),
                            max_batch=16)
        c_one = e_one.build(x, y, pools, 3, np.random.default_rng(50 + r),
                            max_batch=16)
        p_off, l_off = e_off.round(p_off, c_off, LR, total)
        p_one, l_one = e_one.round(p_one, c_one, LR, total)
        out.append(dict(
            shapes=([cb.xs.shape for cb in c_off.buckets],
                    [cb.xs.shape for cb in c_one.buckets]),
            losses=(l_off, l_one), params=(_numpy(p_off), _numpy(p_one))))
    return dict(shards=e_one.shards, rounds=out,
                sharded_dispatches=e_one.stats.sharded_dispatches,
                imbalance=e_one.stats.last_shard_imbalance)


def _trainer_run(np_init, ref_params, trace):
    """``RegionTrainer(cohort_sharding="mesh")`` at the reduced paper
    setup, each round from the reference's params before it."""
    from repro_torch.convert import params_from_jax, params_to_numpy
    from repro_torch.fl import FLConfig, RegionTrainer
    cfg = FLConfig(execution="batched", cohort_sharding="mesh",
                   device="cpu", obs=trace, **COMMON)
    tr = RegionTrainer(cfg, params=params_from_jax(np_init, "cpu"))
    params = []
    for r in range(cfg.n_rounds):
        if r:
            tr.params = params_from_jax(ref_params[r - 1], "cpu")
        tr.step(r)
        params.append(params_to_numpy(tr.params))
    tr.tracer.flush()
    res = tr.result
    return dict(shards=tr.cohort_engine.shards, params=params,
                tracing=tr.tracer.enabled, cases=res.cases,
                times=res.times, accuracies=res.accuracies,
                losses=res.losses)


def _ranks_main(rank, world, init, trainer_args):
    out = dict(sharded=_sharded_run(rank, world, init))
    if trainer_args is not None:
        out["one_rank"] = _one_rank_mesh(init)
        out["trainer"] = _trainer_run(*trainer_args)
    return out


# ---------------------------------------------------------------------------
# the reference's side, in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp
    from repro.fl.cohort_engine import CohortEngine as JEngine

    def init(key, din=32, dh=16, nc=10):
        k1, k2 = jax.random.split(key)
        return {"w1": jax.random.normal(k1, (din, dh)) * 0.1,
                "b1": jnp.zeros((dh,)),
                "w2": jax.random.normal(k2, (dh, nc)) * 0.1,
                "b2": jnp.zeros((nc,))}

    def apply_fn(p, x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]

    x, y = _data()
    p0 = init(jax.random.PRNGKey(0))
    eng = JEngine(apply_fn, batch_align=8, client_align=4, sharding="off")
    params, rounds = p0, []
    for r in range(ROUNDS):
        c = eng.build(x, y, POOLS, 3, np.random.default_rng(10 + r),
                      max_batch=16)
        params, losses = eng.round(params, c, LR, TOTAL)
        rounds.append(({k: np.asarray(v) for k, v in params.items()},
                       losses))
    return dict(init={k: np.asarray(v) for k, v in p0.items()},
                rounds=rounds)


@pytest.fixture(scope="module")
def reference_trainer():
    import jax
    from repro.fl import FLConfig as JFLConfig
    from repro.fl.rounds import RegionTrainer as JTrainer
    tr = JTrainer(JFLConfig(execution="batched", cohort_sharding="off",
                            **COMMON))
    init = jax.tree_util.tree_map(np.asarray, tr.params)
    params = []
    for r in range(COMMON["n_rounds"]):
        tr.step(r)
        params.append(jax.tree_util.tree_map(np.asarray, tr.params))
    return init, params, tr.result


@pytest.fixture(scope="module")
def two_ranks(reference, reference_trainer, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cohort_2")
    init, params, _ = reference_trainer
    return run_ranks(_ranks_main, 2, d / "store",
                     (reference["init"], (init, params,
                                          str(d / "trace.jsonl"))),
                     timeout=600), d


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cohort_4")
    return run_ranks(_ranks_main, 4, d / "store",
                     (reference["init"], None), timeout=600)


def _results(request, world):
    if world == 2:
        return [r["sharded"] for r in request.getfixturevalue("two_ranks")[0]]
    return [r["sharded"] for r in request.getfixturevalue("four_ranks")]


def _close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_engine_matches_reference_off(request, reference, world):
    ranks = _results(request, world)
    for out in ranks:
        assert out["shards"] == world
        for (p, losses), (p_ref, l_ref) in zip(out["rounds"],
                                               reference["rounds"]):
            np.testing.assert_allclose(losses, l_ref, rtol=1e-5, atol=1e-6)
            _close(p, p_ref)
        # guard=True armed every warm round; the layout never changed
        assert out["round_signatures"] == 1
        assert out["stats"]["rounds"] == ROUNDS
        assert out["stats"]["sharded_dispatches"] == \
            out["stats"]["bucket_dispatches"]
    # every rank holds the same model after every round
    for out in ranks[1:]:
        for (p, _), (p0, _) in zip(out["rounds"], ranks[0]["rounds"]):
            for k in p0:
                np.testing.assert_array_equal(p[k], p0[k])


@pytest.mark.parametrize("world", [2, 4])
def test_shard_imbalance_matches_reference_numpy(request, world):
    from repro.data.pipeline import build_bucketed_cohort
    from repro.fl.cohort_engine import CohortEngine as JEngine
    x, y = _data()
    out = _results(request, world)[0]
    want = []
    for r in range(ROUNDS):
        c = build_bucketed_cohort(x, y, POOLS, 3,
                                  np.random.default_rng(10 + r),
                                  max_batch=16, batch_align=8,
                                  client_align=4, client_multiple=world)
        per = JEngine._shard_real_elements(
            types.SimpleNamespace(shards=world), c)
        want.append(float(per.max() * world / per.sum()))
    assert out["imbalance"] == want
    assert out["stats"]["max_shard_imbalance"] == max(want)
    assert out["stats"]["shard_pad_clients"] > 0
    for attrs in out["spans"]:
        assert attrs["mesh_shape"] == [world]
        assert len(attrs["shard_real"]) == world
        assert sum(attrs["shard_real"]) == attrs["real"]


@pytest.mark.parametrize("world", [2, 4])
def test_faulted_round_takes_the_single_device_path(request, world):
    for out in _results(request, world):
        (p_mesh, l_mesh, q_mesh) = out["faulted"]["mesh"]
        (p_off, l_off, q_off) = out["faulted"]["off"]
        assert q_mesh == q_off == 1
        assert l_mesh == l_off
        for k in p_off:
            assert np.isfinite(p_mesh[k]).all()
            np.testing.assert_array_equal(p_mesh[k], p_off[k])


def test_one_rank_mesh_bit_identical_to_off(two_ranks):
    out = two_ranks[0][0]["one_rank"]
    assert two_ranks[0][1]["one_rank"] is None
    assert out["shards"] == 1
    for r in out["rounds"]:
        assert r["shapes"][0] == r["shapes"][1]
        assert r["losses"][0] == r["losses"][1]
        for k in r["params"][0]:
            np.testing.assert_array_equal(r["params"][0][k],
                                          r["params"][1][k])
    assert out["sharded_dispatches"] == 0
    assert out["imbalance"] == 1.0


def test_trainer_mesh_matches_reference_off(two_ranks, reference_trainer):
    from repro_torch.obs import load_jsonl
    ranks, d = two_ranks
    _, ref_params, want = reference_trainer
    tol = 4 / COMMON["eval_size"]
    for out in (r["trainer"] for r in ranks):
        assert out["shards"] == 2
        assert out["cases"] == want.cases
        np.testing.assert_allclose(out["times"], want.times, rtol=1e-12)
        np.testing.assert_allclose(out["accuracies"], want.accuracies,
                                   atol=tol)
        np.testing.assert_allclose(out["losses"], want.losses, atol=1e-3)
        for got, ref in zip(out["params"], ref_params):
            flat = zip(_leaves(got), _leaves(ref))
            for a, b in flat:
                np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    # one trace, rank 0's
    assert [r["trainer"]["tracing"] for r in ranks] == [True, False]
    spans = load_jsonl(str(d / "trace.jsonl"))
    assert [s.kind for s in spans].count("round") == COMMON["n_rounds"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]
