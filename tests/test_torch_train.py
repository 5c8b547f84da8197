"""Parity of the port's training path with the reference's, on the CPU.

For the reduced ``llama3.2-3b`` (GQA, window 64) and ``rwkv6-1.6b``
(RWKV6) configs in float32, the reference's random params go through
``transformer_params_from_jax`` and both packages take the same numpy
batches: ``chunked_ce_loss``, ``loss_fn`` and the gradient of every leaf
against ``jax.value_and_grad(repro.models.transformer.loss_fn)``, one
``make_train_step`` step, remat on and off, ``make_sharded_train_step``
with ``donate`` on and off, and ``make_fl_train_step`` over 2 replicas
with 2 local steps against the reference's ``make_train_step`` per
replica plus the eq.-(13) mean in NumPy (the reference's own mesh step is
red under jax 0.9 and is not the oracle).  Sequences stay at 128 < 256,
where the reference's RWKV6 takes its exact scan.

Tolerances: float32 values and gradients within 1e-4 x (1 + |ref|): the
two packages sum the same f32 products in other orders (forward and
backward matmuls, softmax and norm reductions), which moves the last bits
of each layer's output and its gradient; two layers and the head keep the
difference near 1e-6 of the values.  Params after SGD at lr 0.1 within
1e-5 x (1 + |ref|).  The bf16 case, where both packages round every
product and activation to bf16 in their own places, within 5e-2 x
(1 + |ref|) on the loss and 2e-2 relative in the norm of each gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.convert import (transformer_params_from_jax,
                                 transformer_params_to_numpy)
from repro_torch.launch import train as LT
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

CONFIGS = ["llama3.2-3b", "rwkv6-1.6b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops: as fast
    alone, and under the suite's parallel workers it keeps torch's thread
    pool from oversubscribing the cores (which slowed these tests
    tenfold); the previous count is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
TOL = 1e-4
STEP_TOL = 1e-5
SEQ, BATCH, LR = 128, 2, 0.1


def _cfgs(name, **changes):
    jcfg = dataclasses.replace(jax_get_config(name).reduced(), **changes)
    return jcfg, dataclasses.replace(get_config(name).reduced(), **changes)


def _jax_params(jcfg, seed=0):
    """Built under ``jit`` (an eager ``init_params`` leaves jax 0.9
    retracing later eager calls)."""
    tree = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    return tree, jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
            np.int32)
    else:
        inputs = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(cfg, got, want, tol):
    """``got`` (a port tree) against ``want`` (the reference's numpy
    tree), every leaf within tol x (1 + |want|)."""
    got = dict(jax.tree_util.tree_leaves_with_path(
        transformer_params_to_numpy(cfg, got)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(flat)
    for path, w in flat:
        w = np.asarray(w, np.float32)
        g = got[path]
        assert np.all(np.isfinite(g)), jax.tree_util.keystr(path)
        err = np.abs(g - w)
        assert np.all(err <= tol * (1 + np.abs(w))), (
            f"{jax.tree_util.keystr(path)}: max err {err.max():.3g}")


@pytest.mark.parametrize("s", [1024, 128])
def test_chunked_ce_loss_matches_reference(s):
    """S = 1024 takes two 512-position chunks, S = 128 one chunk of its
    own length; value and the gradients with respect to the hidden
    states and the unembedding."""
    jcfg, cfg = _cfgs("llama3.2-3b")
    jtree, tree = _jax_params(jcfg)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, s)).astype(np.int32)

    def jloss(head, hh):
        return JT.chunked_ce_loss({"lm_head": head}, jcfg, hh,
                                  jnp.asarray(labels))

    want, (want_dhead, want_dh) = jax.value_and_grad(jloss, (0, 1))(
        jtree["lm_head"], jnp.asarray(h))
    head = torch.tensor(tree["lm_head"]["w"], requires_grad=True)
    th = torch.tensor(h, requires_grad=True)
    got = T.chunked_ce_loss({"lm_head": {"w": head}}, cfg, th,
                            torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    np.testing.assert_allclose(head.grad.numpy(), np.asarray(
        want_dhead["w"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh),
                               rtol=TOL, atol=TOL)


def test_chunked_ce_loss_rejects_a_ragged_sequence():
    _, cfg = _cfgs("llama3.2-3b")
    params = T.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="loss chunk"):
        T.chunked_ce_loss(params, cfg, torch.zeros(1, 600, cfg.d_model),
                          torch.zeros(1, 600, dtype=torch.long))


def _reference_value_and_grad(jtree, jcfg, batch):
    (loss, (ce, aux)), grads = jax.value_and_grad(
        JT.loss_fn, has_aux=True)(jtree, jcfg, _jax_batch(batch))
    return (float(loss), float(ce), float(aux)), grads


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_every_gradient_match_reference(name):
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg)
    batch = _batch(cfg, BATCH, SEQ)
    (loss, ce, aux), want = _reference_value_and_grad(jtree, jcfg, batch)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    grads, metrics = T.loss_and_grads(params, cfg, _torch_batch(batch))
    assert float(metrics["aux"]) == aux == 0.0
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=TOL)
    np.testing.assert_allclose(float(metrics["ce"]), ce, rtol=TOL)
    _assert_tree_close(cfg, grads, want, TOL)
    value, (ce_t, _) = T.loss_fn(params, cfg, _torch_batch(batch))
    np.testing.assert_allclose(float(value), loss, rtol=TOL)
    assert float(ce_t) == float(value)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg, seed=1)
    batch = _batch(cfg, BATCH, SEQ, seed=1)
    want, want_metrics = jax.jit(JT.make_train_step(jcfg, lr=LR))(
        jtree, _jax_batch(batch))
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    step = T.make_train_step(cfg, lr=LR, device="cpu")
    got, metrics = step(params, _torch_batch(batch))
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)   # functional: the inputs stay
    _assert_tree_close(cfg, got, jax.tree_util.tree_map(np.asarray, want),
                       STEP_TOL)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(want_metrics[key]), rtol=TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_on_and_off_give_the_same_gradients(name):
    _, cfg = _cfgs(name)
    params = T.init_params(cfg, seed=2, device="cpu")
    batch = _torch_batch(_batch(cfg, BATCH, SEQ, seed=2))
    off, m_off = T.loss_and_grads(params, cfg, batch)
    on, m_on = T.loss_and_grads(params, dataclasses.replace(cfg, remat=True),
                                batch)
    assert float(m_on["loss"]) == float(m_off["loss"])
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_remat_checkpoints_every_block():
    """With ``remat`` the backward pass recomputes each block's forward
    once: every sublayer runs twice per block, once without."""
    _, cfg = _cfgs("llama3.2-3b", remat=True)
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = _torch_batch(_batch(cfg, 1, 64, seed=3))
    calls = []
    real = T._apply_sublayer

    def counted(*args):
        calls.append(1)
        return real(*args)

    T._apply_sublayer = counted
    try:
        T.loss_and_grads(params, cfg, batch)
        with_remat = len(calls)
        calls.clear()
        T.loss_and_grads(params, dataclasses.replace(cfg, remat=False),
                         batch)
        without = len(calls)
        calls.clear()
        with torch.no_grad():
            T.forward(params, cfg, batch["inputs"])
        no_grad = len(calls)
    finally:
        T._apply_sublayer = real
    assert without == no_grad == cfg.n_layers
    assert with_remat == 2 * cfg.n_layers


@pytest.mark.parametrize("name", CONFIGS)
def test_sharded_train_step_donate_on_and_off_agree(name):
    _, cfg = _cfgs(name)
    shape = InputShape("train_cpu", SEQ, BATCH, "train")
    batch = _torch_batch(_batch(cfg, BATCH, SEQ, seed=4))
    kept = T.init_params(cfg, seed=4, device="cpu")
    copy = [t.clone() for t in tree_leaves(kept)]
    new, m_new = LT.make_sharded_train_step(cfg, shape, lr=LR, donate=False,
                                            device="cpu")(kept, batch)
    for a, b in zip(tree_leaves(kept), copy):
        assert torch.equal(a, b)
    donated = T.init_params(cfg, seed=4, device="cpu")
    ids = [id(t) for t in tree_leaves(donated)]
    out, m_out = LT.make_sharded_train_step(cfg, shape, lr=LR,
                                            device="cpu")(donated, batch)
    assert [id(t) for t in tree_leaves(out)] == ids   # updated in place
    for a, b in zip(tree_leaves(out), tree_leaves(new)):
        assert torch.equal(a, b)
    assert float(m_out["loss"]) == float(m_new["loss"])
    with pytest.raises(ValueError, match="seq_len"):
        LT.make_sharded_train_step(cfg, shape, device="cpu")(
            donated, {k: v[:, :64] for k, v in batch.items()})


def test_abstract_params_are_shapes_only():
    _, cfg = _cfgs("llama3.2-3b")
    meta = LT.abstract_params(cfg)
    real = T.init_params(cfg, seed=0, device="cpu")
    for a, b in zip(tree_leaves(meta), tree_leaves(real)):
        assert a.device.type == "meta"
        assert a.shape == b.shape and a.dtype == b.dtype


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _fl_reference(jcfg, jtrees, batches, h_local, agg_dtype):
    """The reference's ``make_train_step`` ``h_local`` times per replica,
    then the eq.-(13) mean over replicas in the reference's own
    arithmetic (``sum(lam * x.astype(agg_dtype))``, lam = 1 / n).
    Returns the mean, the metrics and each leaf's largest magnitude over
    the replicas."""
    step = jax.jit(JT.make_train_step(jcfg, lr=LR))
    outs, metrics = [], []
    for tree, batch in zip(jtrees, batches):
        for _ in range(h_local):
            tree, m = step(tree, _jax_batch(batch))
        outs.append(tree)
        metrics.append({k: float(v) for k, v in m.items()})
    adt = jnp.dtype(agg_dtype)
    lam = jnp.asarray(1.0 / len(outs), adt)
    mean = jax.tree_util.tree_map(
        lambda *xs: np.asarray(jnp.sum(lam * jnp.stack(xs).astype(adt),
                                       axis=0).astype(xs[0].dtype)), *outs)
    largest = jax.tree_util.tree_map(
        lambda *xs: np.max(np.abs(np.stack(xs)), axis=0), *outs)
    return mean, {k: np.mean([m[k] for m in metrics])
                  for k in metrics[0]}, largest


@pytest.mark.parametrize("name", CONFIGS)
def test_fl_train_step_matches_reference(name):
    """Two replicas from different params, each on its own batch, two
    local steps each, then the mean written into both slots."""
    jcfg, cfg = _cfgs(name)
    pairs = [_jax_params(jcfg, seed=s) for s in (5, 6)]
    batches = [_batch(cfg, BATCH, SEQ, seed=s) for s in (5, 6)]
    want, want_metrics, _ = _fl_reference(jcfg, [p[0] for p in pairs],
                                          batches, 2, "float32")
    rep = _stack([transformer_params_from_jax(cfg, p[1], device="cpu")
                  for p in pairs])
    batch = {k: torch.stack([torch.from_numpy(b[k]) for b in batches])
             for k in ("inputs", "labels")}
    shape = InputShape("fl_cpu", SEQ, 2 * BATCH, "train")
    step = LT.make_fl_train_step(cfg, 2, shape, lr=LR, h_local=2,
                                 device="cpu")
    out, metrics = step(rep, batch)
    assert out is rep
    for r in range(2):
        _assert_tree_close(cfg, tree_map(lambda x: x[r], out), want,
                           STEP_TOL)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key]), want_metrics[key],
                                   rtol=TOL)


def test_fl_train_step_bf16_aggregation_matches_reference():
    """``agg_dtype="bfloat16"``: the replicas are stacked in bf16 and the
    mean rounded to bf16, as the reference's bf16 sum does.  Within one
    bf16 ulp of the replicas' own magnitude (2**-7 of it at most): the
    packages' f32 replicas differ in their last bits, which can move a
    replica's bf16 rounding by one step, and the mean of replicas of
    opposite signs keeps that half step (plus its own rounding) however
    small the mean is."""
    jcfg, cfg = _cfgs("llama3.2-3b")
    pairs = [_jax_params(jcfg, seed=s) for s in (7, 8)]
    batches = [_batch(cfg, BATCH, SEQ, seed=s) for s in (7, 8)]
    want, _, largest = _fl_reference(jcfg, [p[0] for p in pairs], batches,
                                     1, "bfloat16")
    rep = _stack([transformer_params_from_jax(cfg, p[1], device="cpu")
                  for p in pairs])
    batch = {k: torch.stack([torch.from_numpy(b[k]) for b in batches])
             for k in ("inputs", "labels")}
    shape = InputShape("fl_cpu", SEQ, 2 * BATCH, "train")
    out, _ = LT.make_fl_train_step(cfg, 2, shape, lr=LR,
                                   agg_dtype="bfloat16", device="cpu")(
                                       rep, batch)
    got = dict(jax.tree_util.tree_leaves_with_path(
        transformer_params_to_numpy(cfg, tree_map(lambda x: x[0], out))))
    bounds = dict(jax.tree_util.tree_leaves_with_path(largest))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got[path]
        assert np.all(np.abs(g - w) <= 2.0 ** -7 * bounds[path]), (
            jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="agg_dtype"):
        LT.make_fl_train_step(cfg, 2, shape, agg_dtype="float16",
                              device="cpu")


def test_fl_train_step_checks_the_replica_axis():
    _, cfg = _cfgs("llama3.2-3b")
    shape = InputShape("fl_cpu", 64, 2, "train")
    step = LT.make_fl_train_step(cfg, 2, shape, device="cpu")
    params = T.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.zeros((2, 1, 64), dtype=torch.long)
             for k in ("inputs", "labels")}
    with pytest.raises(ValueError, match="replica axis"):
        step(params, batch)
    with pytest.raises(ValueError, match="split"):
        LT.make_fl_train_step(cfg, 3, shape, device="cpu")


def test_bf16_loss_and_gradients_match_reference():
    """llama3.2-3b reduced in bfloat16: each package rounds products and
    activations to bf16 in its own places, so the loss within 5e-2 x
    (1 + |ref|) and each gradient leaf within 2e-2 of its norm."""
    jcfg, cfg = _cfgs("llama3.2-3b", param_dtype="bfloat16")
    jtree, tree = _jax_params(jcfg, seed=9)
    batch = _batch(cfg, BATCH, SEQ, seed=9)
    (loss, _, _), want = _reference_value_and_grad(jtree, jcfg, batch)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    grads, metrics = T.loss_and_grads(params, cfg, _torch_batch(batch))
    assert abs(float(metrics["loss"]) - loss) <= 5e-2 * (1 + abs(loss))
    got = dict(jax.tree_util.tree_leaves_with_path(
        transformer_params_to_numpy(cfg, grads)))
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        w = np.asarray(w, np.float32)
        g = got[path]
        assert g.dtype == np.float32 and np.all(np.isfinite(g))
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= 2e-2, (jax.tree_util.keystr(path), rel)
