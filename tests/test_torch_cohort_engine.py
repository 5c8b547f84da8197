"""Parity of the port's cohort engine with the reference's.

A skewed pool set (many small pools and one large one) plans into two
width buckets.  Both engines build their cohort from the same numpy RNG
seed (so they draw the same batches) and run one round from the same
MNIST CNN params; the reference runs single-device (``sharding="off"``,
no donation).  New params agree within 1e-5, losses within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl.cohort_engine import CohortEngine as JaxCohortEngine
from repro.models import cnn as jax_cnn
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl.cohort_engine import CohortEngine
from repro_torch.models import cnn

H, LR, MAX_BATCH = 2, 0.05, 64
POOL_SIZES = [6, 7, 5, 8, 6, 9, 7, 6, 120, 130]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    n = sum(POOL_SIZES)
    # unit-scale logits keep the losses near 1, where 1e-5 is above the
    # float32 rounding of a sum over a batch
    x = (0.1 * rng.normal(size=(n, 28, 28, 1))).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    bounds = np.cumsum([0] + POOL_SIZES)
    pools = [np.arange(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
    params, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(2))
    return x, y, pools, jax.tree_util.tree_map(np.asarray, params)


def test_round_matches_reference_engine(setup):
    x, y, pools, np_params = setup
    ref = JaxCohortEngine(jax_cnn.apply_mnist_cnn, batch_align=8,
                          client_align=4, donate=False, sharding="off")
    eng = CohortEngine(cnn.apply_mnist_cnn, batch_align=8, client_align=4,
                       device="cpu", sharding="off")
    ref_cohort = ref.build(x, y, pools, H, np.random.default_rng(5),
                           max_batch=MAX_BATCH)
    cohort = eng.build(x, y, pools, H, np.random.default_rng(5),
                       max_batch=MAX_BATCH)
    assert len(cohort.buckets) == 2
    for a, b in zip(cohort.buckets, ref_cohort.buckets):
        np.testing.assert_array_equal(a.xs, b.xs)
        np.testing.assert_array_equal(a.mask, b.mask)
    total = sum(POOL_SIZES)
    want, want_losses = ref.round(
        jax.tree_util.tree_map(jnp.asarray, np_params), ref_cohort, LR,
        total)
    got, losses = eng.round(params_from_jax(np_params, "cpu"), cohort, LR,
                            total)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose(losses, want_losses, atol=1e-5)
    assert len(losses) == len(POOL_SIZES)
    # the layout bookkeeping is the reference's
    assert eng.stats.rounds == ref.stats.rounds == 1
    assert eng.stats.bucket_dispatches == ref.stats.bucket_dispatches
    assert eng.stats.compiled_signatures == ref.stats.compiled_signatures
    assert eng.stats.padding_ratio == ref.stats.padding_ratio


def test_sharded_mode_waits_for_multi_gpu():
    """``sharding="mesh"`` is ported (the multi-rank cases are in
    ``tests/test_torch_mesh_cohort.py``): without a process group it is a
    world of one, the single-device path; an unknown mode raises."""
    eng = CohortEngine(cnn.apply_mnist_cnn, device="cpu", sharding="mesh")
    assert eng.mesh is None and eng.shards == 1
    with pytest.raises(ValueError, match="sharding"):
        CohortEngine(cnn.apply_mnist_cnn, device="cpu", sharding="bogus")


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        CohortEngine(cnn.apply_mnist_cnn)
