"""Parity of the port's payload models with the reference's.

Reference params (``jax.random`` init) are carried into the port through
``convert.params_from_jax``; both packages then apply them to the same
numpy batch.  Logits agree within 1e-5 in float32, and ``model_bits``
(Q(w), which drives every latency) is exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jax_cnn
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import cnn

MODELS = [("mnist", (28, 28, 1), 421_642), ("fmnist", (28, 28, 1), None),
          ("cifar10", (32, 32, 3), 9_225_610)]


def _jax_params(name, shape, seed=0):
    params, apply = jax_cnn.build_model(name, jax.random.PRNGKey(seed),
                                        image_shape=shape)
    return jax.tree_util.tree_map(np.asarray, params), apply


@pytest.mark.parametrize("name,shape,n_params", MODELS)
def test_logits_match_reference(name, shape, n_params):
    np_params, jax_apply = _jax_params(name, shape)
    x = np.random.default_rng(0).normal(size=(3,) + shape).astype(
        np.float32)
    want = np.asarray(jax_apply(jax.tree_util.tree_map(jnp.asarray,
                                                       np_params),
                                jnp.asarray(x)))
    params = params_from_jax(np_params, "cpu")
    _, apply = cnn.build_model(name, 0, torch.device("cpu"),
                               image_shape=shape)
    got = apply(params, torch.from_numpy(x)).numpy()
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,shape,n_params", MODELS)
def test_model_bits_and_counts_match_reference(name, shape, n_params):
    np_params, _ = _jax_params(name, shape)
    own, _ = cnn.build_model(name, 0, torch.device("cpu"),
                             image_shape=shape)
    assert cnn.model_bits(own) == jax_cnn.model_bits(np_params)
    assert cnn.param_count(own) == jax_cnn.param_count(np_params)
    if n_params is not None:
        assert cnn.param_count(own) == n_params


@pytest.mark.parametrize("name,shape,n_params", MODELS)
def test_conversion_round_trips(name, shape, n_params):
    np_params, _ = _jax_params(name, shape)
    back = params_to_numpy(params_from_jax(np_params, "cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(np_params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_init_is_seeded_in_port_layout():
    a, _ = cnn.build_model("mnist", 7, torch.device("cpu"))
    b, _ = cnn.build_model("mnist", 7, torch.device("cpu"))
    c, _ = cnn.build_model("mnist", 8, torch.device("cpu"))
    assert torch.equal(a["c1"]["w"], b["c1"]["w"])
    assert not torch.equal(a["c1"]["w"], c["c1"]["w"])
    # OIHW conv kernels, (din, dout) dense weights, as convert produces
    assert a["c1"]["w"].shape == (32, 1, 3, 3)
    assert a["f1"]["w"].shape == (7 * 7 * 64, 128)
