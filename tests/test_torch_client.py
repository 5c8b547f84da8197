"""Parity of the port's local training with the reference's.

The MNIST CNN's reference init is carried into the port; both packages
train it on the same numpy batches (H=2 steps, batches of at most 8).
Params agree within 1e-5 and losses within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import client as jax_client
from repro.models import cnn as jax_cnn
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl import client
from repro_torch.models import cnn
from repro_torch.tree import tree_map

H, B, LR = 2, 8, 0.05


@pytest.fixture(scope="module")
def model():
    params, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, params)


def _batches(shape_prefix, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=shape_prefix + (28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=shape_prefix).astype(np.int32)
    return xs, ys


def _assert_params_close(got, want, atol=1e-5):
    got = params_to_numpy(got)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _jax(np_params):
    return jax.tree_util.tree_map(jnp.asarray, np_params)


def test_local_update_matches_reference(model):
    xs, ys = _batches((H, B))
    want, want_loss = jax_client.local_update(
        jax_cnn.apply_mnist_cnn, _jax(model), jnp.asarray(xs),
        jnp.asarray(ys), LR)
    got, loss = client.local_update(
        cnn.apply_mnist_cnn, params_from_jax(model, "cpu"),
        torch.from_numpy(xs), torch.from_numpy(ys).long(), LR)
    _assert_params_close(got, want)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5)


def test_masked_local_update_matches_reference(model):
    xs, ys = _batches((H, B), seed=1)
    mask = np.ones((H, B), np.float32)
    mask[:, 5:] = 0.0
    want, want_loss = jax_client.masked_local_update(
        jax_cnn.apply_mnist_cnn, _jax(model), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(mask), LR)
    got, loss = client.masked_local_update(
        cnn.apply_mnist_cnn, params_from_jax(model, "cpu"),
        torch.from_numpy(xs), torch.from_numpy(ys).long(),
        torch.from_numpy(mask), LR)
    _assert_params_close(got, want)
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5)
    # the masked slots change nothing: the unpadded update is the same
    unpadded, _ = client.local_update(
        cnn.apply_mnist_cnn, params_from_jax(model, "cpu"),
        torch.from_numpy(xs[:, :5]), torch.from_numpy(ys[:, :5]).long(), LR)
    _assert_params_close(unpadded, params_to_numpy(got))


def test_cohort_local_update_matches_reference(model):
    c = 4
    xs, ys = _batches((c, H, B), seed=2)
    mask = np.ones((c, H, B), np.float32)
    mask[1, :, 3:] = 0.0
    mask[3] = 0.0  # a padding client
    xs[3] = 0.0
    want, want_losses = jax_client.cohort_local_update(
        jax_cnn.apply_mnist_cnn, _jax(model), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(mask), LR)
    params = params_from_jax(model, "cpu")
    got, losses = client.cohort_local_update(
        cnn.apply_mnist_cnn, params, torch.from_numpy(xs),
        torch.from_numpy(ys).long(), torch.from_numpy(mask), LR)
    for i in range(c):
        _assert_params_close(
            tree_map(lambda t: t[i], got),
            jax.tree_util.tree_map(lambda a: np.asarray(a[i]), want))
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses),
                               atol=1e-5)
    # the global params are not written in place
    _assert_params_close(params, model, atol=0)
    # padding client: unchanged params, loss exactly 0
    _assert_params_close(tree_map(lambda t: t[3], got), model, atol=0)
    assert float(losses[3]) == 0.0


def test_all_zero_mask_gives_zero_gradient(model):
    xs, ys = _batches((1, B), seed=3)
    params = params_from_jax(model, "cpu")
    loss_fn = lambda p: client.masked_cross_entropy(  # noqa: E731
        cnn.apply_mnist_cnn(p, torch.from_numpy(xs[0])),
        torch.from_numpy(ys[0]).long(), torch.zeros(B))
    g, loss = torch.func.grad_and_value(loss_fn)(params)
    assert float(loss) == 0.0
    for leaf in jax.tree_util.tree_leaves(params_to_numpy(g)):
        assert not leaf.any()


def test_evaluate_matches_reference(model):
    xs, ys = _batches((32,), seed=4)
    want_loss, want_acc = jax_client.evaluate(
        jax_cnn.apply_mnist_cnn, _jax(model), jnp.asarray(xs),
        jnp.asarray(ys))
    loss, acc = client.evaluate(cnn.apply_mnist_cnn,
                                params_from_jax(model, "cpu"),
                                torch.from_numpy(xs),
                                torch.from_numpy(ys).long())
    np.testing.assert_allclose(float(loss), float(want_loss), atol=1e-5)
    assert float(acc) == float(want_acc)


def _stack_models(np_params, n):
    """``n`` models around ``np_params`` (leading axis n), as numpy."""
    rng = np.random.default_rng(n)
    return jax.tree_util.tree_map(
        lambda a: np.stack([a + 0.01 * rng.standard_normal(a.shape).astype(
            np.float32) for _ in range(n)]), np_params)


def _port_stack(stacked, n):
    """A numpy stack of reference models as the port's stacked tree
    (each model converted, then stacked: conv kernels become OIHW)."""
    models = [params_from_jax(jax.tree_util.tree_map(lambda a: a[i],
                                                     stacked), "cpu")
              for i in range(n)]
    return tree_map(lambda *ts: torch.stack(ts), *models)


def test_vmapped_local_update_matches_reference(model):
    """Three clients, each from its own params and learning rate."""
    c = 3
    stacked = _stack_models(model, c)
    xs, ys = _batches((c, H, B), seed=4)
    lrs = np.array([0.05, 0.01, 0.1], np.float32)
    want, want_loss = jax_client.vmapped_local_update(
        jax_cnn.apply_mnist_cnn, _jax(stacked), jnp.asarray(xs),
        jnp.asarray(ys), jnp.asarray(lrs))
    got, loss = client.vmapped_local_update(
        cnn.apply_mnist_cnn, _port_stack(stacked, c),
        torch.from_numpy(xs), torch.from_numpy(ys).long(),
        torch.from_numpy(lrs))
    assert loss.shape == (c,)
    # losses of 20-200 on these random batches: float32 sums, relative
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-5)
    for i in range(c):
        _assert_params_close(tree_map(lambda t: t[i], got),
                             jax.tree_util.tree_map(lambda a: a[i], want))


def test_stacked_evaluate_matches_reference(model):
    c = 3
    stacked = _stack_models(model, c)
    xs, ys = _batches((64,), seed=5)
    want_loss, want_acc = jax_client.stacked_evaluate(
        jax_cnn.apply_mnist_cnn, _jax(stacked), jnp.asarray(xs),
        jnp.asarray(ys))
    loss, acc = client.stacked_evaluate(
        cnn.apply_mnist_cnn, _port_stack(stacked, c),
        torch.from_numpy(xs), torch.from_numpy(ys).long())
    assert loss.shape == acc.shape == (c,)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want_acc), atol=0)
