"""The port's checkpoints against the reference's, on the CPU.

Parameter trees: the reference's own tests, ported, plus the on-disk
format shared with the JAX package — the same npz keys and a ``.tree``
sidecar byte-identical to what ``jax.tree_util`` prints, so a file of
either package loads in the other.  ``handover_state`` writes the
params in the reference's layout, so its bit count (Q(w) in eq. (7))
is the reference's.

Engines: ``run(4) == run(2, final_merge=False) + save + restore +
run(2)`` bit for bit inside the port, with obs off and on; and a
checkpoint written by either package restores into the other, whose
next round then matches the writer's own next round (cases, latencies
and clocks identical, params within 1e-5).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import handover_state as jax_handover_state
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import restore_engine as jax_restore_engine
from repro.checkpoint import save_engine as jax_save_engine
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.fl import FLConfig as JaxFLConfig
from repro.fl.federation import FederationConfig as JaxFederationConfig
from repro.models import cnn as jax_cnn
from repro.scenarios import Scenario as JaxScenario
from repro.sim import DynamicsConfig as JaxDynamicsConfig
from repro.sim import Region as JaxRegion
from repro.sim import SAGINEngine as JaxEngine
from repro_torch.checkpoint import (handover_state, load_pytree,
                                    restore_engine, save_engine, save_pytree)
from repro_torch.checkpoint.ckpt import treedef_str
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl import FLConfig, FederationConfig
from repro_torch.models.cnn import build_model, param_count
from repro_torch.obs import ObsConfig, load_jsonl
from repro_torch.scenarios import SCENARIOS, Scenario, register
from repro_torch.sim import DynamicsConfig, Region, SAGINEngine
from repro_torch.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
MODELS = [("mnist", (28, 28, 1)), ("fmnist", (28, 28, 1)),
          ("cifar10", (32, 32, 3))]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(name, shape, seed=0):
    params, _ = jax_cnn.build_model(name, jax.random.PRNGKey(seed),
                                    image_shape=shape)
    return params


# ---------------------------------------------------------------------------
# parameter trees: the reference's tests, ported -----------------------------
# ---------------------------------------------------------------------------
def test_roundtrip(tmp_path):
    params, _ = build_model("mnist", 0, CPU)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(params, path)
    loaded = load_pytree(params, path)
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_handover_blob_size_matches_eq7_inputs():
    params, _ = build_model("fmnist", 0, CPU)
    opt_state = tree_map(torch.zeros_like, params)
    blob, bits = handover_state(params, opt_state,
                                {"remaining_samples": 1234, "round": 7})
    assert bits == 8 * len(blob)
    # at least as large as the raw parameters (fp32) twice (params + opt)
    assert bits >= 2 * 32 * param_count(params) * 0.9


def test_roundtrip_nested_state(tmp_path):
    tree = {"a": torch.arange(5), "b": [torch.ones((2, 3)),
                                        {"c": torch.zeros(1)}]}
    path = str(tmp_path / "nested.npz")
    save_pytree(tree, path)
    loaded = load_pytree(tree, path)
    assert torch.equal(loaded["b"][0], torch.ones((2, 3)))
    assert torch.equal(loaded["a"], torch.arange(5))


def test_save_writes_tree_sidecar_and_no_temp_litter(tmp_path):
    tree = {"w": torch.ones(3), "b": torch.zeros(2)}
    path = str(tmp_path / "m")           # suffix-less spelling
    save_pytree(tree, path)
    assert os.path.exists(str(tmp_path / "m.npz"))
    assert os.path.exists(str(tmp_path / "m.npz.tree"))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    loaded = load_pytree(tree, path)     # both spellings load
    assert torch.equal(loaded["w"], torch.ones(3))


def test_load_rejects_key_mismatch(tmp_path):
    path = str(tmp_path / "a.npz")
    save_pytree({"w": torch.ones(3)}, path)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree({"w": torch.ones(3), "extra": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree({"renamed": torch.ones(3)}, path)


def test_load_rejects_treedef_sidecar_mismatch(tmp_path):
    # same flattened keys, different container structure: only the
    # .tree sidecar can tell them apart
    path = str(tmp_path / "s.npz")
    save_pytree({"a": {"b": torch.ones(2)}}, path)
    with pytest.raises(ValueError, match="treedef mismatch"):
        load_pytree({"a/b": torch.ones(2)}, path)


def test_load_without_sidecar_stays_compatible(tmp_path):
    path = str(tmp_path / "old.npz")
    save_pytree({"w": torch.arange(4)}, path)
    os.unlink(path + ".tree")
    loaded = load_pytree({"w": torch.zeros(4, dtype=torch.int32)}, path)
    assert loaded["w"].dtype == torch.int32
    assert torch.equal(loaded["w"], torch.arange(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the on-disk format shared with the reference -------------------------------
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tree", [
    {"a": 1, "b": [2, {"c": 3}]},
    {"p": (1,), "q": None, "r": (1, 2), "s": {}, "t": []},
    7,
], ids=["nested", "containers", "leaf"])
def test_treedef_str_matches_jax(tree):
    assert treedef_str(tree) == str(jax.tree_util.tree_structure(tree))


@pytest.mark.parametrize("name,shape", MODELS, ids=[m for m, _ in MODELS])
def test_model_files_match_reference_files(tmp_path, name, shape):
    """The paper's three CNN trees (VGG-11 keeps a list under ``convs``):
    the port's file of the converted params has the reference's sidecar
    bytes, keys and values, and each package loads the other's file."""
    jparams = _jax_params(name, shape)
    params = params_from_jax(_numpy(jparams), "cpu")
    assert treedef_str(params) == str(jax.tree_util.tree_structure(jparams))
    port_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "ref")
    save_pytree(params_to_numpy(params), port_path)
    jax_save_pytree(jparams, ref_path)
    with open(port_path + ".tree", "rb") as a, \
            open(ref_path + ".npz.tree", "rb") as b:
        assert a.read() == b.read()
    with np.load(port_path) as a, np.load(ref_path + ".npz") as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # the reference reads the port's file, the port the reference's
    back = jax_load_pytree(jparams, port_path)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    got = params_from_jax(load_pytree(params_to_numpy(params), ref_path),
                          "cpu")
    for x, y in zip(tree_leaves(got), tree_leaves(params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name,shape", MODELS, ids=[m for m, _ in MODELS])
def test_handover_bits_match_reference(name, shape):
    jparams = _jax_params(name, shape)
    params = params_from_jax(_numpy(jparams), "cpu")
    manifest = {"remaining_samples": 321, "round": 4}
    blob, bits = handover_state(params, tree_map(torch.zeros_like, params),
                                manifest)
    jblob, jbits = jax_handover_state(
        jparams, jax.tree_util.tree_map(jnp.zeros_like, jparams), manifest)
    assert bits == jbits
    assert blob.split(b"\x00", 1)[0] == jblob.split(b"\x00", 1)[0]


# ---------------------------------------------------------------------------
# engine checkpoint/resume ---------------------------------------------------
# ---------------------------------------------------------------------------
def _resume_scn(pkg_scenario, pkg_region, pkg_dynamics, pkg_fed):
    return pkg_scenario(
        name="_resume", description="checkpoint/resume fixture",
        regions=(pkg_region("indiana", 40.0, -86.0),
                 pkg_region("nairobi", -1.3, 36.8)),
        n_devices=5, n_air=1,
        dynamics=pkg_dynamics(isl_markov=(0.3, 0.5),
                              uplink_markov=(0.2, 0.6),
                              churn_prob=0.1, weather_std=0.1),
        federation=pkg_fed(policy="synchronous", every=2, half_life=3600.0),
        horizon=12 * 3600.0)


RESUME_SCN = _resume_scn(Scenario, Region, DynamicsConfig, FederationConfig)
JAX_RESUME_SCN = _resume_scn(JaxScenario, JaxRegion, JaxDynamicsConfig,
                             JaxFederationConfig)
TINY = dict(n_devices=5, n_air=1, train_fraction=0.005, eval_size=32,
            execution="sequential", seed=3)


def tiny_cfg(**overrides):
    return FLConfig(**{**TINY, "device": "cpu", **overrides})


def assert_same_trajectory(a, b):
    assert set(a.fl_results) == set(b.fl_results)
    for name in a.fl_results:
        ra, rb = a.fl_results[name], b.fl_results[name]
        assert ra.times == rb.times
        assert ra.accuracies == rb.accuracies
        # repr-compare: NaN loss sentinels must match positionally too
        assert [repr(x) for x in ra.losses] == [repr(x) for x in rb.losses]
        assert ra.latencies == rb.latencies
        assert ra.cases == rb.cases
        assert ra.participated == rb.participated
    assert a.merges == b.merges
    if a.global_params is None:
        assert b.global_params is None
    else:
        for x, y in zip(tree_leaves(a.global_params),
                        tree_leaves(b.global_params)):
            assert torch.equal(x, y)
    for ta, tb in zip(a.trainers, b.trainers):
        for x, y in zip(tree_leaves(ta.params), tree_leaves(tb.params)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("obs_on", [False, True], ids=["obs_off", "obs_on"])
def test_resume_is_bit_identical(tmp_path, obs_on):
    """run(4) == run(2, final_merge=False) + checkpoint + resume + run(2),
    with obs off and on (tracing must never perturb the trajectory)."""
    def cfg(tag):
        obs = (ObsConfig(path=str(tmp_path / f"{tag}.jsonl"))
               if obs_on else None)
        return tiny_cfg(obs=obs)

    full = SAGINEngine(RESUME_SCN, fl=cfg("full"))
    full.run(4)
    seg = SAGINEngine(RESUME_SCN, fl=cfg("seg"))
    seg.run(2, final_merge=False)
    ckpt = str(tmp_path / "ckpt")
    save_engine(seg, ckpt)
    res = SAGINEngine(RESUME_SCN, fl=cfg("res"))
    restore_engine(res, ckpt)
    res.run(2)
    assert_same_trajectory(full, res)
    # synchronous every=2 over 4 rounds: merges key on the GLOBAL round
    assert [m.barrier_round for m in full.merges] == [2, 4]
    if obs_on:
        spans = load_jsonl(str(tmp_path / "res.jsonl"))
        resumes = [s for s in spans if s.kind == "resume"]
        assert len(resumes) == 1 and resumes[0].attrs["rounds_done"] == 2
        assert res.tracer.metrics.counter("engine.resumes").value == 1


def test_resume_restores_markov_burst_state(tmp_path):
    seg = SAGINEngine(RESUME_SCN, fl=tiny_cfg())
    seg.run(3, final_merge=False)
    save_engine(seg, str(tmp_path / "c"))
    res = SAGINEngine(RESUME_SCN, fl=tiny_cfg())
    restore_engine(res, str(tmp_path / "c"))
    for t_seg, t_res in zip(seg.trainers, res.trainers):
        mid = t_seg.orch.dynamics.state_dict()
        assert t_res.orch.dynamics.state_dict() == mid
        # mid-run state, not a fresh construction's
        fresh = type(t_res.orch.dynamics)(t_res.orch.dynamics.config,
                                          seed=0)
        assert mid["rng"] != fresh.state_dict()["rng"]


def test_restore_engine_validates_manifest(tmp_path):
    eng = SAGINEngine(RESUME_SCN, fl=tiny_cfg())
    eng.run(2, final_merge=False)
    ckpt = str(tmp_path / "ckpt")
    save_engine(eng, ckpt)
    with pytest.raises(ValueError, match="manifest.json missing"):
        restore_engine(SAGINEngine(RESUME_SCN, fl=tiny_cfg()),
                       str(tmp_path / "nowhere"))
    other = dataclasses.replace(RESUME_SCN, name="_resume_other")
    register(other)
    try:
        with pytest.raises(ValueError, match="scenario"):
            restore_engine(SAGINEngine(other, fl=tiny_cfg()), ckpt)
    finally:
        SCENARIOS.pop(other.name, None)


def test_save_engine_rejects_non_fl_engine(tmp_path):
    eng = SAGINEngine(RESUME_SCN)     # network-only, no trainers
    with pytest.raises(ValueError, match="no region trainers"):
        save_engine(eng, str(tmp_path / "unused"))


def test_engine_holds_no_torch_generator():
    """Every draw of a run comes from the NumPy generators the manifest
    carries: no trainer, cohort engine or engine keeps a torch
    generator whose state a checkpoint would have to save."""
    eng = SAGINEngine(RESUME_SCN, fl=tiny_cfg(execution="batched"))
    objs = [eng] + eng.trainers + [t.cohort_engine for t in eng.trainers]
    assert all(t.cohort_engine is not None for t in eng.trainers)
    for obj in objs:
        assert not any(isinstance(v, torch.Generator)
                       for v in vars(obj).values()), type(obj).__name__


def _assert_next_round_matches(port_eng, jax_eng, rounds_done):
    """One more round of both engines (the port's restored from the
    other's checkpoint, or the reverse): identical control plane, params
    within 1e-5."""
    for name, res in port_eng.fl_results.items():
        want = jax_eng.fl_results[name]
        assert len(res.times) == rounds_done + 1
        assert res.cases == want.cases
        assert res.times == want.times
        assert res.latencies == want.latencies
        assert res.participated == want.participated
        np.testing.assert_allclose(res.accuracies, want.accuracies,
                                   atol=4 / TINY["eval_size"])
    for got, want in zip(port_eng.merges, jax_eng.merges):
        assert ((got.barrier_round, got.time, got.staleness, got.weights,
                 got.isl_costs, got.participants, got.recipients)
                == (want.barrier_round, want.time, want.staleness,
                    want.weights, want.isl_costs, want.participants,
                    want.recipients))
    pairs = [(t.params, jt.params) for t, jt in zip(port_eng.trainers,
                                                    jax_eng.trainers)]
    pairs.append((port_eng.global_params, jax_eng.global_params))
    for p, jp in pairs:
        for a, b in zip(tree_leaves(params_to_numpy(p)),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jeng = JaxEngine(JAX_RESUME_SCN, fl=JaxFLConfig(**TINY))
    jeng.run(2, final_merge=False)
    ckpt = str(tmp_path / "ref_ckpt")
    jax_save_engine(jeng, ckpt)
    jeng.run(1)                                  # the reference's own next
    eng = restore_engine(SAGINEngine(RESUME_SCN, fl=tiny_cfg()), ckpt)
    eng.run(1)
    assert len(eng.merges) == len(jeng.merges) == 2
    _assert_next_round_matches(eng, jeng, 2)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    init = params_from_jax(_numpy(_jax_params("mnist", (28, 28, 1),
                                              TINY["seed"])), "cpu")
    eng = SAGINEngine(RESUME_SCN, fl=tiny_cfg(), params=init)
    eng.run(2, final_merge=False)
    ckpt = str(tmp_path / "port_ckpt")
    save_engine(eng, ckpt)
    eng.run(1)                                   # the port's own next
    jeng = JaxEngine(JAX_RESUME_SCN, fl=JaxFLConfig(**TINY))
    jax_restore_engine(jeng, ckpt)
    jeng.run(1)
    assert len(eng.merges) == len(jeng.merges) == 2
    _assert_next_round_matches(eng, jeng, 2)
