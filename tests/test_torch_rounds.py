"""The slice end to end: the port's ``run_fl`` against the reference's.

The reference runs its sequential loop; the port runs both of its modes
on the CPU from the reference's initial model, carried across with
``convert.params_from_jax``.  The NumPy control plane is the same code
in both packages, so plan cases are equal and latencies and wall clocks
agree to 1e-12; accuracies and losses agree within 1e-3.  The same
holds with the Walker-Star constellation driving the coverage windows
(``scenario="paper"``, ``use_constellation=True``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.fl import FLConfig as JaxFLConfig, run_fl as jax_run_fl
from repro.models import cnn as jax_cnn
from repro_torch.convert import params_from_jax
from repro_torch.fl import FLConfig, RegionTrainer, run_fl
from repro_torch.obs import ObsConfig, Tracer
from repro_torch.serve import ServeConfig

COMMON = dict(dataset="mnist", n_rounds=2, train_fraction=0.005,
              n_devices=4, n_air=1, h_local=2, eval_size=64, seed=3)


@pytest.fixture(scope="module")
def reference():
    res = jax_run_fl(JaxFLConfig(execution="sequential", **COMMON))
    params, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(3),
                                    image_shape=(28, 28, 1))
    return res, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_run_fl_matches_reference(reference, execution):
    want, np_params = reference
    got = run_fl(FLConfig(execution=execution, device="cpu", **COMMON),
                 params=params_from_jax(np_params, "cpu"))
    _assert_same_run(got, want)


def _assert_same_run(got, want):
    assert got.cases == want.cases
    np.testing.assert_allclose(got.latencies, want.latencies, rtol=1e-12)
    np.testing.assert_allclose(got.times, want.times, rtol=1e-12)
    np.testing.assert_allclose(got.accuracies, want.accuracies, atol=1e-3)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-3)
    assert got.participated == want.participated
    assert got.layer_portions == want.layer_portions


def test_trainer_exposes_what_later_slices_read():
    tr = RegionTrainer(FLConfig(device="cpu", **COMMON))
    for name in ("sagin", "ds", "x_eval", "y_eval", "cfg", "region",
                 "params", "wall_clock", "pools"):
        assert hasattr(tr, name), name
    assert tr.x_eval.device.type == "cpu"
    assert tr.execution == "sequential"   # "auto" on the CPU
    assert tr.cohort_engine is None


def test_auto_execution_resolves_by_device():
    assert FLConfig(device="cpu").resolved_execution() == "sequential"
    assert FLConfig().resolved_execution() == "batched"


def test_cuda_by_default_and_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert FLConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        RegionTrainer(FLConfig(**COMMON))


@pytest.mark.parametrize("constellation", [
    dict(scenario="paper"), dict(use_constellation=True)])
@pytest.mark.parametrize("execution", ["sequential", "batched"])
def test_constellation_runs_match_reference(reference, constellation,
                                            execution):
    """Coverage windows from the 80-satellite Walker-Star (the paper
    preset over 48 h, or the bare constellation over 6 h) set each
    round's T_i in both packages alike."""
    _, np_params = reference
    want = jax_run_fl(JaxFLConfig(execution="sequential", **constellation,
                                  **COMMON))
    got = run_fl(FLConfig(execution=execution, device="cpu",
                          **constellation, **COMMON),
                 params=params_from_jax(np_params, "cpu"))
    _assert_same_run(got, want)


def test_run_fl_hands_a_positional_tracer_to_the_trainer():
    """``run_fl(cfg, tracer)`` and ``RegionTrainer(cfg, scenario,
    intervals, tracer)`` take the reference's positional order."""
    tracer = Tracer(ObsConfig(path=None))
    res = run_fl(FLConfig(device="cpu", **dict(COMMON, n_rounds=1)), tracer)
    assert [s.kind for s in tracer.spans].count("round") == 1
    assert len(res.accuracies) == 1
    tr = RegionTrainer(FLConfig(device="cpu", **COMMON), None, None, tracer)
    assert tr.tracer is tracer
    with pytest.raises(TypeError):
        run_fl(FLConfig(device="cpu", **COMMON), None, None)


# Fields that once waited for a slice of the port; a field whose slice
# has landed is held to accepting the value (``guard_recompiles``: the
# tooling slice; tests/test_torch_contracts.py runs it;
# ``cohort_sharding="mesh"``: the multi-device FL slice,
# tests/test_torch_mesh_cohort.py runs it)
PORTED_FIELDS = {"guard_recompiles", "cohort_sharding"}


@pytest.mark.parametrize("field,value", [
    ("guard_recompiles", True), ("cohort_sharding", "mesh")])
def test_fields_not_yet_ported_raise(field, value):
    if field in PORTED_FIELDS:
        assert getattr(FLConfig(device="cpu", **{field: value}),
                       field) == value
        return
    with pytest.raises(ValueError, match="ROADMAP"):
        FLConfig(**{field: value})


def test_serve_field_takes_none_or_a_serve_config():
    assert FLConfig(device="cpu").serve is None
    cfg = ServeConfig(base_rate=3.0)
    assert FLConfig(serve=cfg, device="cpu").serve is cfg
    with pytest.raises(TypeError, match="ServeConfig"):
        FLConfig(serve="min_rt")


@pytest.mark.parametrize("field,value", [
    ("use_constellation", True), ("scenario", "paper"),
    ("federation", "soft_async"), ("quarantine", True)])
def test_fields_of_the_sim_slice_accepted(field, value):
    assert getattr(FLConfig(**{field: value}), field) == value


def test_config_fields_match_reference():
    """Every reference field exists in the port under the same name."""
    ref = {f.name for f in dataclasses.fields(JaxFLConfig)}
    port = {f.name for f in dataclasses.fields(FLConfig)}
    assert ref <= port and port - ref == {"device"}


@pytest.mark.parametrize("variant", [
    dict(execution="batched", cohort_bucketing="global"),
    dict(iid=False), dict(dataset="fmnist"), dict(rayleigh=False),
    dict(strategy="none"), dict(strategy="air_ground"),
    dict(strategy="ground_space"), dict(strategy="static"),
    dict(strategy="proportional"),
], ids=["global_buckets", "non_iid", "fmnist", "no_rayleigh", "none",
        "air_ground", "ground_space", "static", "proportional"])
def test_run_fl_variant_matches_reference(variant):
    """One round of each configuration from the reference's initial
    model: identical cases, latencies, clocks and layer portions, equal
    accuracies, losses within 1e-5 (the reference runs its sequential
    loop)."""
    kw = dict(COMMON, n_rounds=1, **variant)
    port_exec = kw.pop("execution", "sequential")
    want = jax_run_fl(JaxFLConfig(execution="sequential", **kw))
    params, _ = jax_cnn.build_model(kw["dataset"], jax.random.PRNGKey(3),
                                    image_shape=(28, 28, 1))
    got = run_fl(FLConfig(execution=port_exec, device="cpu", **kw),
                 params=params_from_jax(
                     jax.tree_util.tree_map(np.asarray, params), "cpu"))
    assert got.cases == want.cases
    assert got.latencies == want.latencies
    assert got.times == want.times
    assert got.layer_portions == want.layer_portions
    assert got.participated == want.participated
    assert got.accuracies == want.accuracies
    np.testing.assert_allclose(got.losses, want.losses, rtol=0, atol=1e-5)
