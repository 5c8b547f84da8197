"""Parity of the port's optimizers (``repro_torch.optim``) with the
reference's ``repro.optim``: the same random tree of params and three
rounds of gradients, made with numpy, through ``make_optimizer`` in both
packages; params and optimizer state agree at 1e-6 (both compute the
same f32 arithmetic elementwise, in the same order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro_torch import optim
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-6
SHAPES = {"dense": {"w": (8, 5), "b": (5,)},
          "convs": [{"k": (3, 3, 2, 4)}, {"k": (4,)}],
          "scale": ()}


def _tree(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_tree(rng, v) for v in shapes]
    return rng.normal(size=shapes).astype(np.float32)


def _np(tree):
    return [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(tree)]


def _torch_np(tree):
    return [leaf.numpy() for leaf in tree_leaves(tree)]


CASES = [("sgd", {}), ("sgd", {"momentum": 0.9}),
         ("sgd", {"weight_decay": 0.01}),
         ("sgd", {"momentum": 0.9, "weight_decay": 0.01}),
         ("adam", {}), ("adamw", {"weight_decay": 0.05}),
         ("adam", {"b1": 0.8, "eps": 1e-6})]


@pytest.mark.parametrize("name,kw", CASES)
def test_three_updates_match_reference(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    grads = [_tree(rng, SHAPES) for _ in range(3)]
    ref_opt = jax_optim.make_optimizer(name, **kw)
    opt = optim.make_optimizer(name, **kw)
    assert opt.name == ref_opt.name
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = ref_opt.init(jp), opt.init(tp)
    for g in grads:
        jp, js = ref_opt.update(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                js, 0.05)
        tp, ts = opt.update(tp, tree_map(torch.from_numpy, g), ts, 0.05)
    for got, want in zip(_torch_np(tp), _np(jp)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if name == "sgd" and not kw.get("momentum"):
        assert ts == () and js == ()
        return
    got_state, want_state = tree_leaves(ts), _np(js)
    assert len(got_state) == len(want_state)
    for got, want in zip(got_state, want_state):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if name != "sgd":
        assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3


def test_update_leaves_inputs_untouched():
    rng = np.random.default_rng(1)
    params = tree_map(torch.from_numpy, _tree(rng, SHAPES))
    before = [t.clone() for t in tree_leaves(params)]
    grads = tree_map(torch.from_numpy, _tree(rng, SHAPES))
    opt = optim.make_optimizer("adamw", weight_decay=0.1)
    opt.update(params, grads, opt.init(params), 0.1)
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("lion")
