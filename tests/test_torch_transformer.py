"""Parity of the port's transformer stack with the reference's, on the
CPU in float32.

For reduced configs of every family this slice ports — ``llama3.2-3b``
(GQA, window 64 so that S = 128 exercises it), ``olmo-1b``
(non-parametric LN, MHA), ``qwen3-32b`` (qk-norm), ``musicgen-medium``
(embeddings input), ``rwkv6-1.6b`` (the RWKV6 block),
``deepseek-coder-33b`` (GQA, llama architecture) and ``internvl2-1b``
(GQA over embeddings input) — the reference's random params go through
``transformer_params_from_jax`` and both packages run the same numpy
inputs: ``forward`` / ``logits_fn`` over a sequence, and ``serve_step``
token by token with its caches; and, for the dense configs that
``test_torch_train.py`` does not cover, ``loss_fn`` and the gradient of
every leaf.  The reference is called directly, without a mesh.

Tolerance 1e-4 (abs and rel) on hidden states and logits of magnitude
~1-4: the two packages sum the same f32 products in other orders (matmul
blocking, softmax and norm reductions), which moves the last bits of
each layer's output; two layers and a head keep that under 1e-5, and
1e-4 leaves a decade of room.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import (transformer_params_from_jax,
                                 transformer_params_to_numpy)
from repro_torch.models import transformer as T

CONFIGS = ["llama3.2-3b", "olmo-1b", "qwen3-32b", "musicgen-medium",
           "rwkv6-1.6b", "deepseek-coder-33b", "internvl2-1b"]
TOL = 1e-4
SEQ = 128


def _jax_cache(jcfg, batch, cache_len):
    """The reference's decode cache, built under ``jit``: called eagerly,
    its ``vmap`` over the blocks leaves JAX (0.9) retracing every later
    eager ``jnp.ones``, which ``tests/test_contracts.py`` counts as
    recompiles when it runs after this file in the same process."""
    return jax.jit(JT.init_cache, static_argnums=(0, 1, 2))(
        jcfg, batch, cache_len)


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


def _cfgs(name):
    return jax_get_config(name).reduced(), get_config(name).reduced()


def _jax_init(jcfg, seed):
    """The reference's params, built under ``jit``: called eagerly, its
    ``vmap`` over the blocks leaves JAX (0.9) retracing every later eager
    ``jnp.ones``, which later tests in the same process count as
    recompiles."""
    return jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def _jax_params(jcfg, seed=0):
    tree = _jax_init(jcfg, seed)
    return tree, jax.tree_util.tree_map(np.asarray, tree)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _torch_inputs(x):
    t = torch.from_numpy(x)
    return t.long() if t.dtype == torch.int32 else t


@pytest.mark.parametrize("name", CONFIGS)
def test_init_params_tree_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    want = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = T.init_params(cfg, seed=0, device="cpu")
    nb = T.n_blocks(cfg)
    assert len(got["blocks"]) == nb

    def check(w, g, path):
        if isinstance(w, dict):
            assert isinstance(g, dict) and set(w) == set(g), path
            for key in w:
                check(w[key], g[key], f"{path}/{key}")
            return
        shape = w.shape[1:] if path.startswith("blocks") else w.shape
        assert tuple(g.shape) == tuple(shape), path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path

    for block in got["blocks"]:
        check(want["blocks"], block, "blocks")
    check({k: v for k, v in want.items() if k != "blocks"},
          {k: v for k, v in got.items() if k != "blocks"}, "")
    # the 1/sqrt(fan_in) scale of the reference's _init
    wq = got["embed"]["w"] if "embed" in got else got["in_proj"]["w"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_logits_match_reference(name):
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    x = _inputs(cfg, 2, SEQ)
    want_h, _ = JT.forward(jtree, jcfg, jnp.asarray(x))
    want_logits, _ = JT.logits_fn(jtree, jcfg, jnp.asarray(x))
    with torch.no_grad():
        got_h, aux = T.forward(params, cfg, _torch_inputs(x))
        got_logits, _ = T.logits_fn(params, cfg, _torch_inputs(x))
    assert float(aux) == 0.0
    assert got_logits.shape == (2, SEQ, cfg.padded_vocab)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)


def _jax_cache_leaf(jcache, i, sub, key):
    return np.asarray(jcache[sub][key][i])


@pytest.mark.parametrize("name", CONFIGS)
def test_serve_steps_match_reference(name):
    """Eight decode steps: logits and every cache tensor agree with the
    reference's ``serve_step`` called directly."""
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg, seed=1)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    x = _inputs(cfg, 2, 8, seed=1)
    jcache = _jax_cache(jcfg, 2, 16)
    cache = T.init_cache(cfg, 2, 16, device="cpu")
    for pos in range(8):
        want, jcache = JT.serve_step(jtree, jcfg, jcache,
                                     jnp.asarray(x[:, pos:pos + 1]), pos)
        with torch.no_grad():
            got, cache = T.serve_step(params, cfg, cache,
                                      _torch_inputs(x[:, pos:pos + 1]), pos)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    for i, block in enumerate(cache):
        for sub, entries in block.items():
            for key, t in entries.items():
                np.testing.assert_allclose(
                    t.float().numpy(), _jax_cache_leaf(jcache, i, sub, key),
                    rtol=TOL, atol=TOL, err_msg=f"{i}/{sub}/{key}")


@pytest.mark.parametrize("name", CONFIGS)
def test_decode_matches_prefill(name):
    """Token-by-token decode over 80 positions gives the prefill's
    logits at every position (llama's window of 64 wraps the ring)."""
    cfg = get_config(name).reduced()
    params = T.init_params(cfg, seed=2, device="cpu")
    x = _torch_inputs(_inputs(cfg, 2, 80, seed=2))
    with torch.no_grad():
        full, _ = T.logits_fn(params, cfg, x)
        cache = T.init_cache(cfg, 2, 80, device="cpu")
        for pos in range(80):
            got, cache = T.serve_step(params, cfg, cache,
                                      x[:, pos:pos + 1], pos)
            np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(),
                                       rtol=TOL, atol=TOL)


def test_decode_past_the_window_matches_reference():
    """Reduced llama3.2-3b (window 64) decoded over 100 positions, so
    the ring cache wraps after 64: the port's ``serve_step`` matches the
    reference's at every position, and the port's windowed prefill."""
    jcfg, cfg = _cfgs("llama3.2-3b")
    assert cfg.sliding_window == jcfg.sliding_window == 64
    jtree, tree = _jax_params(jcfg, seed=4)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    x = _inputs(cfg, 2, 100, seed=4)
    jstep = jax.jit(JT.serve_step, static_argnums=1)
    jcache = _jax_cache(jcfg, 2, 100)
    cache = T.init_cache(cfg, 2, 100, device="cpu")
    assert cache[0]["sub0"]["k"].shape[2] == 64
    with torch.no_grad():
        full, _ = T.logits_fn(params, cfg, _torch_inputs(x))
        for pos in range(100):
            want, jcache = jstep(jtree, jcfg, jcache,
                                 jnp.asarray(x[:, pos:pos + 1]),
                                 jnp.int32(pos))
            got, cache = T.serve_step(params, cfg, cache,
                                      _torch_inputs(x[:, pos:pos + 1]), pos)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL, err_msg=str(pos))
            np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=str(pos))


def test_sliding_window_cache_is_bounded():
    cfg = get_config("llama3.2-3b").reduced()
    assert cfg.sliding_window == 64
    cache = T.init_cache(cfg, 1, 1000, device="cpu")
    assert cache[0]["sub0"]["k"].shape == (1, cfg.n_kv_heads, 64,
                                           cfg.head_dim)
    params = T.init_params(cfg, seed=3, device="cpu")
    with torch.no_grad():
        for pos in range(70):
            _, cache = T.serve_step(params, cfg, cache,
                                    torch.tensor([[pos % 7]]), pos)
    assert cache[0]["sub0"]["k"].shape[2] == 64
    assert T.init_cache(get_config("rwkv6-1.6b").reduced(), 1, 1000,
                        device="cpu")[0]["sub0"]["wkv"].shape == (
                            1, 4, 64, 64)


# every registered config: the round trip covers the MLA, MoE and Mamba
# trees too (f32 router, ``kv_norm`` and Mamba's f32 leaves among the
# others, the nested shared expert, 3-D expert leaves stacked over the
# layers)
@pytest.mark.parametrize("name", list(REGISTRY))
def test_converter_round_trip(name):
    jcfg, cfg = _cfgs(name)
    _, tree = _jax_params(jcfg, seed=4)
    back = transformer_params_to_numpy(
        cfg, transformer_params_from_jax(cfg, tree, device="cpu"))
    flat_want = jax.tree_util.tree_leaves_with_path(tree)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_converter_keeps_bf16_and_checks_shapes():
    jcfg, cfg = _cfgs("llama3.2-3b")
    import dataclasses
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    _, tree = _jax_params(jcfg, seed=5)
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    wq = params["blocks"][1]["sub0"]["mixer"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        tree["blocks"]["sub0"]["mixer"]["wq"][1].astype(np.float32))
    back = transformer_params_to_numpy(cfg, params)
    np.testing.assert_array_equal(
        back["embed"]["w"], tree["embed"]["w"].astype(np.float32))
    tree["blocks"]["sub0"]["mixer"]["wq"] = tree["blocks"]["sub0"][
        "mixer"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        transformer_params_from_jax(cfg, tree, device="cpu")


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-32b", "musicgen-medium",
                                  "deepseek-coder-33b", "internvl2-1b"])
def test_loss_gradients_match_reference(name):
    """``loss_fn`` and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's, at the file's ``TOL`` x
    (1 + |grad|): the same products summed in other orders, forward and
    backward (llama3.2-3b and rwkv6-1.6b are in ``test_torch_train.py``).
    """
    jcfg, cfg = _cfgs(name)
    jtree, tree = _jax_params(jcfg, seed=6)
    rng = np.random.default_rng(6)
    x = _inputs(cfg, 2, SEQ, seed=6)
    labels = rng.integers(0, cfg.vocab_size, size=(2, SEQ)).astype(np.int32)
    (loss, _), want = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jtree, jcfg, {"inputs": jnp.asarray(x),
                      "labels": jnp.asarray(labels)})
    params = transformer_params_from_jax(cfg, tree, device="cpu")
    grads, metrics = T.loss_and_grads(
        params, cfg, {"inputs": _torch_inputs(x),
                      "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        transformer_params_to_numpy(cfg, grads)))
    flat = jax.tree_util.tree_leaves_with_path(want)
    assert len(got) == len(flat)
    for path, w in flat:
        w = np.asarray(w)
        err = np.abs(got[path] - w)
        assert np.all(err <= TOL * (1 + np.abs(w))), (
            jax.tree_util.keystr(path), float(err.max()))
