"""Parity of the port's MLA and MoE FFN with the reference's, on the CPU.

Layers: ``moe_apply`` over both dispatch paths (grouped per sequence,
flat over the batch), at the shipping capacity factor 1.25 and at 0.5,
where the test asserts that some expert overflows and tokens drop, with
a tie (two identical token rows), its gradients with respect to ``x`` and
every leaf against ``jax.vjp``, one bf16 case, ``moe_aux_loss``,
``mla_apply`` and ``mla_decode`` token by token.  Models: the reduced
``deepseek-v2-lite-16b`` (MLA + MoE, ``n_experts=8``: top-6 of 8, one
shared expert) and ``qwen3-moe-235b-a22b`` (GQA with qk-norm + MoE,
``n_experts=16``: top-8 of 16), so that routing picks k < e and drops
tokens; ``forward`` / ``logits_fn`` with the aux loss, ``serve_step``,
``loss_fn`` with every leaf's gradient and ``aux`` against
``jax.value_and_grad``, remat on and off, decode against prefill, and a
2-replica ``make_fl_train_step`` against the reference's
``make_train_step`` per replica plus the eq.-(13) mean.  The reference
runs through its own functions without a mesh; params go through
``convert.transformer_params_from_jax`` or the same numpy leaves.

Tolerances, float32: values and gradients within 1e-4 x (1 + |ref|), as
in ``test_torch_transformer.py``: the packages sum the same f32 products
in other orders.  Routing itself is exact (the same f32 softmax over the
same logits up to the last bits, with no near-ties at these seeds), so a
disagreement in which expert a token went to would show as an error of
the outputs' own size.  bf16: see ``test_moe_apply_bf16``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.shapes import InputShape
from repro_torch.convert import (transformer_params_from_jax,
                                 transformer_params_to_numpy)
from repro_torch.launch import train as LT
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

TOL = 1e-4
STEP_TOL = 1e-5
LR = 0.1
# reduced so that k < e: deepseek top-6 of 8 (+1 shared), qwen3-moe top-8
# of 16; ``ModelConfig.reduced()``'s default of 4 experts has k = e
EXPERTS = {"deepseek-v2-lite-16b": 8, "qwen3-moe-235b-a22b": 16}
MODELS = list(EXPERTS)
SEQ = 64


def _jax_cache(jcfg, batch, cache_len):
    """The reference's decode cache, built under ``jit``: called eagerly,
    its ``vmap`` over the blocks leaves JAX (0.9) retracing every later
    eager ``jnp.ones``, which ``tests/test_contracts.py`` counts as
    recompiles when it runs after this file in the same process."""
    return jax.jit(JT.init_cache, static_argnums=(0, 1, 2))(
        jcfg, batch, cache_len)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops (as in
    ``test_torch_transformer.py``); the previous count is restored."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(name, **changes):
    jcfg = jax_get_config(name).reduced(n_experts=EXPERTS[name])
    cfg = get_config(name).reduced(n_experts=EXPERTS[name])
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(cfg, **changes))


def _leaves(tree):
    """A reference layer's params (numpy or jax leaves, bf16 included) as
    torch tensors of the same values and types."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(one, tree)


def _layer(init, jcfg, seed):
    """A reference layer's params, built under ``jit`` (an eager init
    leaves jax 0.9 retracing later eager calls)."""
    return jax.jit(init, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))


def _with_vjp(fn, dout):
    """``fn``'s output and the gradients of ``sum(fn(*args) * dout)``
    with respect to every argument, under ``jit`` (eager, the reference's
    ops compile one by one, which takes tens of seconds here)."""
    def run(*args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(jnp.asarray(dout))
    return jax.jit(run)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), (what, float(err.max()))


def _overflows(jcfg, p, x):
    """Whether some expert is chosen by more tokens than its capacity, on
    the path ``jcfg`` takes: per sequence (grouped) or over the batch."""
    b, s, _ = x.shape
    k, e = jcfg.n_experts_active, jcfg.n_experts
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    chosen = np.asarray(jax.nn.one_hot(top_i, e).sum(axis=2))   # (B,S,E)
    n = s if jcfg.moe_grouped and s > 1 else b * s
    cap = max(1, min(n, int(k * n / e * jcfg.capacity_factor)))
    per = (chosen.sum(axis=1) if jcfg.moe_grouped and s > 1
           else chosen.sum(axis=(0, 1)))
    return bool((per > cap).any())


MOE_CASES = [(name, grouped, cf) for name in MODELS
             for grouped in (True, False) for cf in (1.25, 0.5)]


@pytest.mark.parametrize("name,grouped,cf", MOE_CASES)
def test_moe_apply_matches_reference(name, grouped, cf):
    """Output and every gradient (``x`` and each leaf, against
    ``jax.vjp`` with the same cotangent); at capacity factor 0.5 some
    expert overflows and drops tokens."""
    jcfg, cfg = _cfgs(name, moe_grouped=grouped, capacity_factor=cf)
    jp = _layer(JL.moe_init, jcfg, 0)
    x = _x((2, 32, cfg.d_model), 0)
    dout = _x((2, 32, cfg.d_model), 1)
    if cf < 1:
        assert _overflows(jcfg, jp, x)

    want, (want_dp, want_dx) = _with_vjp(
        lambda p, xx: JL.moe_apply(p, xx, jcfg), dout)(jp, jnp.asarray(x))
    p = _leaves(jp)
    tracked = jax.tree_util.tree_map(lambda t: t.requires_grad_(), p)
    tx = torch.tensor(x, requires_grad=True)
    got = L.moe_apply(tracked, tx, cfg)
    torch.sum(got * torch.from_numpy(dout)).backward()
    _close(got, want, what="out")
    _close(tx.grad, want_dx, what="dx")
    flat = jax.tree_util.tree_leaves_with_path(want_dp)
    got_dp = dict(jax.tree_util.tree_leaves_with_path(tracked))
    assert len(flat) == len(got_dp)
    for path, w in flat:
        _close(got_dp[path].grad, w, what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("grouped", [True, False])
def test_moe_apply_tie_of_identical_tokens(grouped):
    """Two identical token rows (and a third, in the other sequence)
    route identically and tie in the preference of every expert they
    chose; at capacity factor 0.5 both packages keep the same ones."""
    name = "qwen3-moe-235b-a22b"
    jcfg, cfg = _cfgs(name, moe_grouped=grouped, capacity_factor=0.5)
    jp = _layer(JL.moe_init, jcfg, 2)
    x = _x((2, 32, cfg.d_model), 2)
    x[:, 9] = x[:, 4]
    x[1, 20] = x[0, 4]
    want = jax.jit(JL.moe_apply, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    got = L.moe_apply(_leaves(jp), torch.from_numpy(x), cfg)
    _close(got, want)


def test_moe_apply_bf16():
    """deepseek (grouped and one decode token through the flat path) in
    bfloat16 against the reference in bfloat16.  The router runs in f32
    from the same bf16 activations in both, so the routing is the same;
    each package then rounds every einsum, the SiLU product and the sum
    over k to bf16 in its own places, a few bf16 roundings (2**-8
    relative each) of the output: within 2e-2 x (1 + |ref|), the bf16
    tolerance the card's checks use, which an expert or slot mixed up
    would exceed by far."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b", param_dtype="bfloat16")
    jp = _layer(JL.moe_init, jcfg, 3)
    p = _leaves(jp)
    assert p["router"].dtype == torch.float32
    assert p["we1"].dtype == torch.bfloat16
    for shape in ((2, 32, cfg.d_model), (4, 1, cfg.d_model)):
        x = _x(shape, 3)
        want = jax.jit(JL.moe_apply, static_argnums=2)(
            jp, jnp.asarray(x, jnp.bfloat16), jcfg)
        got = L.moe_apply(p, torch.from_numpy(x).to(torch.bfloat16), cfg)
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want, np.float32), tol=2e-2)


@pytest.mark.parametrize("name", MODELS)
def test_moe_aux_loss_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    jp = _layer(JL.moe_init, jcfg, 4)
    x = _x((2, 32, cfg.d_model), 4)
    want, want_dx = jax.jit(jax.value_and_grad(
        lambda xx: JL.moe_aux_loss(jp, xx, jcfg)))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = L.moe_aux_loss(_leaves(jp), tx, cfg)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL)
    _close(tx.grad, want_dx)


def test_mla_apply_and_decode_match_reference():
    """Prefill over 32 positions, with every gradient; then 12 decode
    steps into a 16-slot latent cache, outputs and both cache tensors."""
    jcfg, cfg = _cfgs("deepseek-v2-lite-16b")
    jp = _layer(JL.mla_init, jcfg, 5)
    p = _leaves(jp)
    x = _x((2, 32, cfg.d_model), 5)
    dout = _x((2, 32, cfg.d_model), 6)
    pos = jnp.arange(32, dtype=jnp.int32)

    want, (want_dp, want_dx) = _with_vjp(
        lambda pp, xx: JL.mla_apply(pp, xx, jcfg, pos), dout)(
            jp, jnp.asarray(x))
    tracked = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(), p)
    tx = torch.tensor(x, requires_grad=True)
    got = L.mla_apply(tracked, tx, cfg, torch.arange(32, dtype=torch.int32))
    torch.sum(got * torch.from_numpy(dout)).backward()
    _close(got, want, what="out")
    _close(tx.grad, want_dx, what="dx")
    got_dp = dict(jax.tree_util.tree_leaves_with_path(tracked))
    for path, w in jax.tree_util.tree_leaves_with_path(want_dp):
        _close(got_dp[path].grad, w, what=jax.tree_util.keystr(path))

    jcache = JL.mla_init_cache(jcfg, 2, 16, jnp.float32)
    cache = L.mla_init_cache(cfg, 2, 16, torch.float32, torch.device("cpu"))
    decode = jax.jit(JL.mla_decode, static_argnums=4)
    with torch.no_grad():
        for t in range(12):
            xt = x[:, t:t + 1]
            want, jcache = decode(jp, jnp.asarray(xt), jcache, t, jcfg)
            got, cache = L.mla_decode(p, torch.from_numpy(xt), cache, t, cfg)
            _close(got, want, what=f"decode {t}")
    for key in ("c_kv", "k_rope"):
        _close(cache[key], jcache[key], what=key)


def _jax_params(jcfg, seed):
    tree = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    return tree, jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
                np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(cfg, got, want, tol):
    got = dict(jax.tree_util.tree_leaves_with_path(
        transformer_params_to_numpy(cfg, got)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(flat)
    for path, w in flat:
        g = got[path]
        assert np.all(np.isfinite(g)), jax.tree_util.keystr(path)
        _close(g, w, tol=tol, what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", MODELS)
def test_init_params_and_cache(name):
    """The tree, shapes and types of the reference's params (the f32
    router, and MLA's f32 ``kv_norm``, among bf16 leaves at the shipping
    dtype), and a decode cache of the reference's shapes."""
    jcfg = jax_get_config(name).reduced(n_experts=EXPERTS[name])
    cfg = get_config(name).reduced(n_experts=EXPERTS[name])
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    want = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = transformer_params_to_numpy(cfg, T.init_params(cfg, seed=0,
                                                         device="cpu"))
    meta = T.init_params(cfg, device="meta")
    flat = jax.tree_util.tree_leaves_with_path(want)
    got_flat = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat) == len(got_flat)
    for path, w in flat:
        assert got_flat[path].shape == w.shape, jax.tree_util.keystr(path)
    ffn = meta["blocks"][0]["sub0"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["we1"].dtype == torch.bfloat16
    assert ffn["we1"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert ffn["we2"].shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    assert ("shared" in ffn) == bool(cfg.n_shared_experts)
    if cfg.attention == "mla":
        assert meta["blocks"][0]["sub0"]["mixer"]["kv_norm"].dtype == (
            torch.float32)
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    for path, w in jax.tree_util.tree_leaves_with_path(jcache):
        leaf = cache[0]
        for key in path[:2]:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == w.shape[1:], jax.tree_util.keystr(path)
        assert leaf.dtype == torch.bfloat16


@pytest.mark.parametrize("name", MODELS)
def test_forward_logits_and_serve_steps_match_reference(name):
    """``forward`` / ``logits_fn`` over 64 positions with the aux loss,
    then 8 ``serve_step``s (the flat path, a global capacity over the
    batch of 2) with every cache tensor."""
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg, 0)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    x = _batch(cfg, 2, SEQ, 0)["inputs"]

    @jax.jit
    def reference(t, inputs):
        h, aux = JT.forward(t, jcfg, inputs)
        return h, aux, JT.unembed(t, jcfg, h)   # = JT.logits_fn

    want_h, want_aux, want_logits = reference(jtree, jnp.asarray(x))
    with torch.no_grad():
        h, aux = T.forward(params, cfg, torch.from_numpy(x).long())
        logits, aux2 = T.logits_fn(params, cfg, torch.from_numpy(x).long())
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)
    assert float(aux2) == float(aux)
    _close(h, want_h, what="h")
    _close(logits, want_logits, what="logits")

    jcache = _jax_cache(jcfg, 2, 16)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    serve = jax.jit(JT.serve_step, static_argnums=1)
    for pos in range(8):
        tok = x[:, pos:pos + 1]
        want, jcache = serve(jtree, jcfg, jcache, jnp.asarray(tok), pos)
        with torch.no_grad():
            got, cache = T.serve_step(params, cfg, cache,
                                      torch.from_numpy(tok).long(), pos)
        _close(got, want, what=f"step {pos}")
    for i, block in enumerate(cache):
        for sub, entries in block.items():
            for key, t in entries.items():
                _close(t, np.asarray(jcache[sub][key][i]),
                       what=f"{i}/{sub}/{key}")


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_prefill_at_high_capacity(name):
    """Token-by-token decode over 48 positions gives the prefill's logits
    at every position once no token drops: the capacity factor raised to
    n_experts / n_experts_active rounded up to an integer (2 and 2 here),
    so that ``cap`` = S on the grouped path and = B on the flat one.  At
    the shipping 1.25 decode drops tokens by design (the flat path's
    capacity is global over the batch) and differs from prefill."""
    _, cfg = _cfgs(name)
    cf = -(-cfg.n_experts // cfg.n_experts_active)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cf))
    params = T.init_params(cfg, seed=2, device="cpu")
    x = torch.from_numpy(_batch(cfg, 2, 48, 2)["inputs"]).long()
    with torch.no_grad():
        full, _ = T.logits_fn(params, cfg, x)
        cache = T.init_cache(cfg, 2, 48, device="cpu")
        for pos in range(48):
            got, cache = T.serve_step(params, cfg, cache,
                                      x[:, pos:pos + 1], pos)
            _close(got, full[:, pos], what=f"pos {pos}")


@pytest.mark.parametrize("name", MODELS)
def test_loss_gradients_and_aux_match_reference(name):
    """``loss_fn`` (ce + 0.01 aux), ``ce``, ``aux`` and every leaf's
    gradient against ``jax.value_and_grad`` of the reference's; remat on
    gives the same loss, aux and gradients as remat off."""
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg, 6)
    batch = _batch(cfg, 2, SEQ, 6)
    (loss, (ce, aux)), want = jax.jit(jax.value_and_grad(
        JT.loss_fn, has_aux=True), static_argnums=1)(jtree, jcfg,
                                                     _jax_batch(batch))
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    grads, metrics = T.loss_and_grads(params, cfg, _torch_batch(batch))
    assert float(aux) > 0
    for key, w in (("loss", loss), ("ce", ce), ("aux", aux)):
        np.testing.assert_allclose(float(metrics[key]), float(w), rtol=TOL,
                                   err_msg=key)
    _assert_tree_close(cfg, grads, want, TOL)
    on, m_on = T.loss_and_grads(params, dataclasses.replace(cfg, remat=True),
                                _torch_batch(batch))
    for key in ("loss", "ce", "aux"):
        assert float(m_on[key]) == float(metrics[key]), key
    for a, b in zip(jax.tree_util.tree_leaves(on),
                    jax.tree_util.tree_leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("name", MODELS)
def test_fl_train_step_matches_reference(name):
    """Two replicas from different params, each on its own batch, two
    local SGD steps each (the reference's ``make_train_step``), then the
    eq.-(13) mean written into both slots; the metrics carry ``aux``."""
    jcfg, cfg = _cfgs(name)
    pairs = [_jax_params(jcfg, s) for s in (7, 8)]
    batches = [_batch(cfg, 1, SEQ, s) for s in (7, 8)]
    step = jax.jit(JT.make_train_step(jcfg, lr=LR))
    outs, metrics = [], []
    for (jtree, _), batch in zip(pairs, batches):
        for _ in range(2):
            jtree, m = step(jtree, _jax_batch(batch))
        outs.append(jtree)
        metrics.append({k: float(v) for k, v in m.items()})
    want = jax.tree_util.tree_map(
        lambda *xs: np.asarray(jnp.sum(jnp.asarray(0.5) * jnp.stack(xs),
                                       axis=0)), *outs)
    rep = tree_map(lambda *xs: torch.stack(xs),
                   *[transformer_params_from_jax(cfg, p[1], device="cpu")
                     for p in pairs])
    batch = {k: torch.stack([torch.from_numpy(b[k][0]).long()
                             for b in batches])[:, None]
             for k in ("inputs", "labels")}
    shape = InputShape("fl_cpu", SEQ, 2, "train")
    out, got = LT.make_fl_train_step(cfg, 2, shape, lr=LR, h_local=2,
                                     device="cpu")(rep, batch)
    for r in range(2):
        _assert_tree_close(cfg, tree_map(lambda t: t[r], out), want,
                           STEP_TOL)
    assert float(got["aux"]) > 0
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[key]),
                                   np.mean([m[key] for m in metrics]),
                                   rtol=TOL, err_msg=key)
