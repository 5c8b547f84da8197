"""Parity of the port's Mamba block and the reduced jamba with the
reference's, on the CPU.

Scan: ``_mamba_ssm_scan`` per step (``chunk`` = 0) and in checkpointed
chunks of 64 against the reference's, at init-like decays (dt ~ 0.01,
where the reference's chunked form is right) with every gradient, and at
strong decays (dt up to 0.2 over jamba's a = -(1..16)), where the port's
chunked form is held to the reference's per-step scan: the reference's
own chunked form divides by a cumulative decay product and is far off
there, which one assertion records.  Layer: ``mamba_apply`` at the
reduced jamba's width in float32 and bfloat16 with every gradient
against ``jax.vjp``, ``mamba_init_cache`` and ``mamba_decode`` step by
step, and a decode chain against the prefill.  Model: the reduced
``jamba-1.5-large-398b`` (one 8-layer block, 1 GQA + 7 Mamba layers,
dense and 4-expert MoE FFNs alternating, d 256, window 64) through
``forward``, ``serve_step``, decode against prefill at a raised capacity
factor, ``loss_fn`` with every gradient and ``aux``, remat on and off,
one ``make_train_step`` step and the 2-replica ``make_fl_train_step``.
The reference runs through its own functions without a mesh, under
``jax.jit``; params go through ``convert.transformer_params_from_jax``
or the same numpy leaves.

Tolerances, float32: values and gradients within 1e-4 x (1 + |ref|), as
in ``test_torch_moe_mla.py`` (the packages sum the same f32 products in
other orders), the scan alone within 1e-5 x (1 + |ref|) (the same
per-step products; only the 16-term sum over the state differs in
order).  bf16: see ``test_mamba_apply_matches_reference``.
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
SCAN_TOL = 1e-5
STEP_TOL = 1e-5
LR = 0.1
NAME = "jamba-1.5-large-398b"
# two chunks of the default mamba_scan_chunk (64), so that the model
# tests run the chunked, checkpointed scan
SEQ = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's many small CPU ops (as in
    ``test_torch_transformer.py``); the previous count is restored."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**changes):
    """The reduced jamba in both packages; the reference's scans per step
    (``mamba_scan_chunk`` 0), the port's in its default chunks of 64.
    The reference's chunked scan is no oracle for gradients: at init, at
    3 of the 7 seeds 5-11 (B 1, S 128), its loss gradients hold NaNs
    (its closed form divides by a clamped decay product)."""
    jcfg = dataclasses.replace(jax_get_config(NAME).reduced(),
                               mamba_scan_chunk=0, **changes)
    cfg = dataclasses.replace(get_config(NAME).reduced(), **changes)
    return jcfg, cfg


def _leaves(tree):
    """A reference layer's params (bf16 included) as torch tensors of the
    same values and types."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(one, tree)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert np.all(err <= tol * (1 + np.abs(want))), (what, float(err.max()))


# ---------------------------------------------------------------------------
# The scan ------------------------------------------------------------------
# ---------------------------------------------------------------------------
B, DI, ST = 2, 32, 16


def _scan_inputs(s, dt, seed):
    """u, dt, b, c, a of the scan: jamba's a = -(1..16) on every channel;
    ``dt`` a constant, or None for init-like draws (softplus of the
    reference's dt_bias -4.6 plus noise: ~0.01)."""
    u, b, c = (_x(shape, seed + i) for i, shape in enumerate(
        ((B, s, DI), (B, s, ST), (B, s, ST))))
    if dt is None:
        dts = np.log1p(np.exp(_x((B, s, DI), seed + 3, 0.5) - 4.6))
    else:
        dts = np.full((B, s, DI), dt)
    a = -np.broadcast_to(np.arange(1, ST + 1), (DI, ST))
    return u, dts.astype(np.float32), b, c, a.astype(np.float32)


def _ref_scan(chunk, dout):
    """The reference's scan and its gradients with respect to u, dt, b, c,
    under ``jit``."""
    def run(u, dt, b, c, a):
        y, vjp = jax.vjp(lambda *x: JL._mamba_ssm_scan(*x, a, chunk=chunk),
                         u, dt, b, c)
        return y, vjp(jnp.asarray(dout))
    return jax.jit(run)


def _port_scan(inputs, chunk, dout):
    tracked = [torch.tensor(x, requires_grad=True) for x in inputs[:4]]
    y = L._mamba_ssm_scan(*tracked, torch.from_numpy(inputs[4]),
                          chunk=chunk)
    torch.sum(y * torch.from_numpy(dout)).backward()
    return y, [t.grad for t in tracked]


@pytest.mark.parametrize("chunk", [0, 64])
@pytest.mark.parametrize("s", [1, 100, 128])
def test_scan_matches_reference_at_init_decays(chunk, s):
    """Output against the reference's scan at the same ``chunk`` (100 is
    no multiple of 64: both fall back to the per-step form), gradients
    against ``jax.vjp`` of the reference's per-step scan."""
    inputs = _scan_inputs(s, None, s)
    dout = _x((B, s, DI), s + 9)
    want = _ref_scan(chunk, dout)(*inputs)[0]
    _, want_grads = _ref_scan(0, dout)(*inputs)
    got, grads = _port_scan(inputs, chunk, dout)
    _close(got, want, SCAN_TOL, "y")
    for name, g, w in zip("u dt b c".split(), grads, want_grads):
        _close(g, w, TOL, name)


@pytest.mark.parametrize("dt", [0.05, 0.1, 0.2])
def test_chunked_scan_stays_right_at_strong_decays(dt):
    """The port's chunked scan (and its per-step one) against the
    reference's per-step scan, values and gradients, at decays
    exp(-dt x 16) down to 0.04 a step; the reference's chunked form is
    more than 1.0 off at dt 0.2 (its closed form divides by a decay
    product that underflows), so it is no oracle here."""
    s = 128
    inputs = _scan_inputs(s, dt, 20)
    dout = _x((B, s, DI), 29)
    want, want_grads = _ref_scan(0, dout)(*inputs)
    for chunk in (64, 0):
        got, grads = _port_scan(inputs, chunk, dout)
        _close(got, want, SCAN_TOL, f"y, chunk {chunk}")
        for name, g, w in zip("u dt b c".split(), grads, want_grads):
            _close(g, w, TOL, f"{name}, chunk {chunk}")
    if dt == 0.2:
        ref_chunked = _ref_scan(64, dout)(*inputs)[0]
        assert float(jnp.abs(ref_chunked - want).max()) > 1.0


# ---------------------------------------------------------------------------
# The layer -----------------------------------------------------------------
# ---------------------------------------------------------------------------
def _layer(jcfg, seed):
    return jax.jit(JL.mamba_init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_reference(dtype):
    """Output and every gradient (``x`` and each leaf) against
    ``jax.vjp`` with the same cotangent, over two scan chunks.  bf16:
    both packages round the projections and the gated output to bf16 at
    the same casts and keep the conv, dt and the scan in f32, so they
    differ by a few bf16 roundings (2**-8 relative each) of the output
    and the gradients: within 2e-2 x (1 + |ref|), the bf16 tolerance of
    ``test_torch_moe_mla.py``."""
    jcfg, cfg = _cfgs(param_dtype=dtype)
    tol = TOL if dtype == "float32" else 2e-2
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = _layer(jcfg, 0)
    x = _x((2, SEQ, cfg.d_model), 0)
    dout = _x((2, SEQ, cfg.d_model), 1)

    def run(p, xx):
        out, vjp = jax.vjp(lambda pp, xv: JL.mamba_apply(pp, xv, jcfg), p,
                           xx)
        return out, vjp(jnp.asarray(dout, jdt))
    want, (want_dp, want_dx) = jax.jit(run)(jp, jnp.asarray(x, jdt))
    tracked = jax.tree_util.tree_map(lambda t: t.requires_grad_(),
                                     _leaves(jp))
    assert tracked["a_log"].dtype == torch.float32
    assert tracked["in_proj"].dtype == getattr(torch, dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_()
    got = L.mamba_apply(tracked, tx, cfg)
    torch.sum(got.float() * torch.from_numpy(dout).to(got.dtype).float()
              ).backward()
    assert got.dtype == getattr(torch, dtype)
    _close(got, np.asarray(want, np.float32), tol, "out")
    _close(tx.grad, np.asarray(want_dx, np.float32), tol, "dx")
    for path, w in jax.tree_util.tree_leaves_with_path(want_dp):
        g = dict(jax.tree_util.tree_leaves_with_path(tracked))[path].grad
        _close(g, np.asarray(w, np.float32), tol,
               jax.tree_util.keystr(path))


def test_mamba_init_cache_and_decode_match_reference():
    """The cache's shapes and types; 12 decode steps against the
    reference's, outputs and both cache tensors; and the decode chain's
    outputs against the port's prefill at every position."""
    jcfg, cfg = _cfgs()
    jp = _layer(jcfg, 2)
    p = _leaves(jp)
    x = _x((2, 12, cfg.d_model), 2)
    init_cache = jax.jit(JL.mamba_init_cache, static_argnums=(0, 1, 2))
    jcache = init_cache(jcfg, 2, jnp.bfloat16)
    cache = L.mamba_init_cache(cfg, 2, torch.bfloat16, torch.device("cpu"))
    for key in ("h", "conv"):
        assert tuple(cache[key].shape) == jcache[key].shape, key
        assert str(cache[key].dtype).split(".")[-1] == str(
            jcache[key].dtype), key
    jcache = init_cache(jcfg, 2, jnp.float32)
    cache = L.mamba_init_cache(cfg, 2, torch.float32, torch.device("cpu"))
    decode = jax.jit(JL.mamba_decode, static_argnums=3)
    with torch.no_grad():
        full = L.mamba_apply(p, torch.from_numpy(x), cfg)
        for t in range(12):
            xt = x[:, t:t + 1]
            want, jcache = decode(jp, jnp.asarray(xt), jcache, jcfg)
            got, cache = L.mamba_decode(p, torch.from_numpy(xt), cache, cfg)
            _close(got, want, what=f"decode {t}")
            _close(got[:, 0], full[:, t].numpy(), what=f"prefill {t}")
    for key in ("h", "conv"):
        _close(cache[key], jcache[key], what=key)


# ---------------------------------------------------------------------------
# The reduced jamba ---------------------------------------------------------
# ---------------------------------------------------------------------------
def _jax_params(jcfg, seed):
    tree = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    return tree, jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {key: rng.integers(0, cfg.vocab_size, size=(b, s)).astype(
                np.int32) for key in ("inputs", "labels")}


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


def test_block_template_matches_reference():
    """One 8-layer block: GQA first, then 7 Mamba layers, the FFNs dense
    and MoE alternating, as the reference's template; at full width and
    at the 2-layer cut (``attn_every`` 2)."""
    for changes in ({}, {"n_layers": 2, "attn_every": 2}):
        jcfg = dataclasses.replace(jax_get_config(NAME), **changes)
        cfg = dataclasses.replace(get_config(NAME), **changes)
        want = [(s.mixer, s.ffn) for s in JT.block_template(jcfg)]
        assert [(s.mixer, s.ffn) for s in T.block_template(cfg)] == want
    assert want == [("gqa", "swiglu"), ("mamba", "moe")]


def test_init_params_and_cache():
    """The reference's tree, shapes and types at the shipping bf16 (the
    Mamba layers' conv, dt, A and skip leaves in f32 among bf16
    projections), and a decode cache of the reference's shapes and types
    (the state in f32, the conv's inputs in the cache's type)."""
    jcfg, cfg = _cfgs(param_dtype="bfloat16")
    want = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    meta = T.init_params(cfg, device="meta")
    got = transformer_params_to_numpy(cfg, T.init_params(cfg, seed=0,
                                                         device="cpu"))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(got)
    for path, w in flat:
        assert got[path].shape == w.shape, jax.tree_util.keystr(path)
    mixer = meta["blocks"][0]["sub1"]["mixer"]
    for key, leaf in mixer.items():
        want_dtype = (torch.bfloat16 if key.endswith("_proj")
                      and key != "dt_proj" else torch.float32)
        assert leaf.dtype == want_dtype, key
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 16))
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    for path, w in jax.tree_util.tree_leaves_with_path(jcache):
        leaf = cache[0]
        for key in path[:2]:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == w.shape[1:], jax.tree_util.keystr(path)
        assert str(leaf.dtype).split(".")[-1] == str(w.dtype), (
            jax.tree_util.keystr(path))


def test_forward_and_serve_steps_match_reference():
    """``forward`` / ``logits_fn`` over 128 positions (two scan chunks)
    with the aux loss, then 8 ``serve_step``s with every cache tensor."""
    jcfg, cfg = _cfgs()
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
        logits, _ = T.logits_fn(params, cfg, torch.from_numpy(x).long())
    assert float(want_aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL)
    _close(h, want_h, what="h")
    _close(logits, want_logits, what="logits")

    jcache = jax.jit(JT.init_cache, static_argnums=(0, 1, 2))(jcfg, 2, 16)
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


def test_decode_matches_prefill_at_high_capacity():
    """Token-by-token decode over 80 positions (the window of 64 wraps
    the attention's ring) gives the prefill's logits at every position
    once no token drops: the capacity factor raised to n_experts /
    n_experts_active = 2, so that ``cap`` = S on the grouped path and
    = B on the flat one."""
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, capacity_factor=float(
        -(-cfg.n_experts // cfg.n_experts_active)))
    params = T.init_params(cfg, seed=2, device="cpu")
    x = torch.from_numpy(_batch(cfg, 2, 80, 2)["inputs"]).long()
    with torch.no_grad():
        full, _ = T.logits_fn(params, cfg, x)
        cache = T.init_cache(cfg, 2, 80, device="cpu")
        for pos in range(80):
            got, cache = T.serve_step(params, cfg, cache,
                                      x[:, pos:pos + 1], pos)
            _close(got, full[:, pos], what=f"pos {pos}")


def test_loss_gradients_and_aux_match_reference():
    """``loss_fn`` (ce + 0.01 aux), ``ce``, ``aux`` and every leaf's
    gradient against ``jax.value_and_grad`` of the reference's; remat on
    gives the same loss, aux and gradients as remat off."""
    jcfg, cfg = _cfgs()
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


def test_train_step_matches_reference():
    """One ``make_train_step`` step (SGD) from the same params and batch:
    every leaf after the step, and the metrics."""
    jcfg, cfg = _cfgs()
    jtree, tree = _jax_params(jcfg, 5)
    batch = _batch(cfg, 2, SEQ, 5)
    want, want_m = jax.jit(JT.make_train_step(jcfg, lr=LR))(
        jtree, _jax_batch(batch))
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    got, metrics = T.make_train_step(cfg, lr=LR, device="cpu")(
        params, _torch_batch(batch))
    _assert_tree_close(cfg, got, want, STEP_TOL)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key]), float(want_m[key]),
                                   rtol=TOL, err_msg=key)


def test_fl_train_step_matches_reference():
    """Two replicas from different params, each on its own batch, two
    local SGD steps each (the reference's ``make_train_step``), then the
    eq.-(13) mean written into both slots; the metrics carry ``aux``."""
    jcfg, cfg = _cfgs()
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
