"""Parity of the port's eq.-(13) aggregation with the reference's.

Stacked client models made from a seed go through the reference's
aggregation functions and the port's (which reduce through the port's
``fedavg_agg`` op, its plain version on the CPU).  Float32, 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import aggregation as jax_agg
from repro_torch.fl import aggregation as agg
from repro_torch.tree import tree_leaves, tree_map


def _models(n, seed=0):
    """n models in a nested dict+list tree (the VGG-11 nesting)."""
    rng = np.random.default_rng(seed)
    return [{"convs": [{"w": rng.normal(size=(3, 3, 2, 4)).astype(
                            np.float32),
                        "b": rng.normal(size=(4,)).astype(np.float32)}],
             "fc": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(np.float32)}}
            for _ in range(n)]


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _close(got, want, atol=1e-6):
    for a, b in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=0)


def _leaves(tree):
    return [t.numpy() for t in tree_leaves(tree)]


WEIGHTS = [0.1, 0.5, 0.25, 0.15]


def test_fedavg_matches_reference():
    models = _models(4)
    _close(agg.fedavg([_t(m) for m in models], WEIGHTS),
           jax_agg.fedavg(models, WEIGHTS))


def test_fedavg_stacked_and_multi_match_reference():
    models = _models(4, seed=1)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *models)
    w = np.asarray([3.0, 1.0, 0.0, 2.0], np.float32)  # unnormalized
    want = jax_agg.fedavg_stacked(stacked, jnp.asarray(w))
    _close(agg.fedavg_stacked(_t(stacked), torch.from_numpy(w)), want)
    parts = [tree_map(lambda a: a[:1], stacked),
             tree_map(lambda a: a[1:], stacked)]
    want_multi = jax_agg.fedavg_stacked_multi(parts, jnp.asarray(w))
    _close(agg.fedavg_stacked_multi([_t(p) for p in parts],
                                    torch.from_numpy(w)), want_multi)
    _close(agg.fedavg_stacked_multi([_t(stacked)], torch.from_numpy(w)),
           want)


@pytest.mark.parametrize("half_life", [None, 0.0, 5.0, 1e-3])
def test_staleness_merge_matches_reference(half_life):
    sizes, stale = [10.0, 30.0, 5.0], [0.0, 4.0, 12.0]
    want_w = jax_agg.staleness_merge_weights(sizes, stale, half_life)
    np.testing.assert_array_equal(
        agg.staleness_merge_weights(sizes, stale, half_life), want_w)
    models = _models(3, seed=2)
    want, ww = jax_agg.staleness_weighted_merge(
        models, sizes, stale, half_life, return_weights=True)
    got, gw = agg.staleness_weighted_merge(
        [_t(m) for m in models], sizes, stale, half_life,
        return_weights=True)
    np.testing.assert_array_equal(gw, ww)
    _close(got, want)


def test_fedavg_pytrees_single_model_is_identity():
    m = _t(_models(1)[0])
    assert agg.fedavg_pytrees([m], [1.0]) is m


def test_finiteness_gates_match_reference():
    models = _models(3, seed=3)
    models[1]["fc"]["b"][0] = np.nan
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *models)
    np.testing.assert_array_equal(
        agg.client_finite_mask(_t(stacked)).numpy(),
        np.asarray(jax_agg.client_finite_mask(stacked)))
    for m in models:
        assert agg.tree_all_finite(_t(m)) == jax_agg.tree_all_finite(m)


def test_aggregation_weights_match_reference():
    want = jax_agg.aggregation_weights([3, 4], [5], 8)
    got = agg.aggregation_weights([3, 4], [5], 8, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)


@pytest.mark.parametrize("split", [(3, 1), (1, 1, 2), (4,)])
def test_fedavg_stacked_multi_bucket_splits_match_reference(split):
    """Buckets of any split aggregate as the reference's concatenation."""
    models = _models(sum(split), seed=4)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *models)
    w = np.asarray([1.0, 2.0, 0.0, 3.0][:sum(split)], np.float32)
    bounds = np.cumsum((0,) + split)
    parts = [tree_map(lambda a, lo=lo, hi=hi: a[lo:hi], stacked)
             for lo, hi in zip(bounds, bounds[1:])]
    want = jax_agg.fedavg_stacked_multi(parts, jnp.asarray(w))
    _close(agg.fedavg_stacked_multi([_t(p) for p in parts],
                                    torch.from_numpy(w)), want)


def test_fedavg_stacked_multi_is_one_op_call_without_concatenation(
        monkeypatch):
    """One aggregate, one call of the op with every bucket's leaves as
    they are: the buckets are never concatenated on the way."""
    models = _models(4, seed=5)
    stacked = _t(jax.tree_util.tree_map(lambda *xs: np.stack(xs), *models))
    parts = [tree_map(lambda a: a[:3], stacked),
             tree_map(lambda a: a[3:], stacked)]
    calls, cats = [], []

    def spy(buckets, weights):
        calls.append((buckets, weights))
        return [torch.zeros(x.shape[1:]) for x in buckets[0]]

    real_cat = torch.cat

    def counting_cat(*args, **kwargs):
        cats.append(args)
        return real_cat(*args, **kwargs)

    monkeypatch.setattr(agg.agg_ops, "aggregate", spy)
    monkeypatch.setattr(torch, "cat", counting_cat)
    out = agg.fedavg_stacked_multi(parts, torch.ones(4))
    assert len(calls) == 1 and not cats
    buckets, weights = calls[0]
    assert len(buckets) == 2
    for leaves, part in zip(buckets, parts):
        assert all(a is b for a, b in zip(leaves, tree_leaves(part)))
    assert weights.shape == (4,)
    assert [t.shape for t in tree_leaves(out)] == [
        t.shape[1:] for t in tree_leaves(stacked)]
