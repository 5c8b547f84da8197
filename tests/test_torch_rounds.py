"""The slice end to end: the port's ``run_fl`` against the reference's.

The reference runs its sequential loop; the port runs both of its modes
on the CPU from the reference's initial model, carried across with
``convert.params_from_jax``.  The NumPy control plane is the same code
in both packages, so plan cases are equal and latencies and wall clocks
agree to 1e-12; accuracies and losses agree within 1e-3.
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


@pytest.mark.parametrize("field,value", [
    ("use_constellation", True), ("scenario", "paper"),
    ("guard_recompiles", True), ("cohort_sharding", "mesh"),
    ("federation", "soft_async"), ("serve", object()),
    ("quarantine", True)])
def test_fields_not_yet_ported_raise(field, value):
    with pytest.raises(ValueError, match="ROADMAP"):
        FLConfig(**{field: value})


def test_config_fields_match_reference():
    """Every reference field exists in the port under the same name."""
    ref = {f.name for f in dataclasses.fields(JaxFLConfig)}
    port = {f.name for f in dataclasses.fields(FLConfig)}
    assert ref <= port and port - ref == {"device"}
