"""The port's prefill step, serve step and serving backends against the
reference, on the CPU in float32.

The reference's ``make_prefill_step`` / ``make_serve_step`` /
``TransformerBackend`` build on a mesh whose explicit shardings fail
under this JAX version, so the oracle is the reference's
``forward`` + ``unembed`` and ``serve_step`` called directly on the same
(converted) params.  Tolerance 1e-4, as in ``test_torch_transformer.py``
and for the same reason.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import cnn as jax_cnn
from repro.models import transformer as JT
from repro_torch.configs import InputShape, get_config
from repro_torch.convert import params_from_jax, transformer_params_from_jax
from repro_torch.launch.serve import make_serve_step
from repro_torch.launch.train import make_prefill_step
from repro_torch.models import cnn
from repro_torch.models import transformer as T
from repro_torch.serve import CNNBackend, TransformerBackend

TOL = 1e-4


def _jax_cache(jcfg, batch, cache_len):
    """The reference's decode cache, built under ``jit``: called eagerly,
    its ``vmap`` over the blocks leaves JAX (0.9) retracing every later
    eager ``jnp.ones``, which ``tests/test_contracts.py`` counts as
    recompiles when it runs after this file in the same process."""
    return jax.jit(JT.init_cache, static_argnums=(0, 1, 2))(
        jcfg, batch, cache_len)


def _jax_init(jcfg, seed):
    """The reference's params, built under ``jit`` as in
    ``test_torch_transformer.py`` (an eager call leaves JAX retracing
    later eager ``jnp.ones`` calls)."""
    return jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def _setup(name, seed=0, **reduce):
    jcfg = jax_get_config(name).reduced(**reduce)
    cfg = get_config(name).reduced(**reduce)
    jtree = _jax_init(jcfg, seed)
    params = transformer_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    return jcfg, cfg, jtree, params


@pytest.mark.parametrize("name", ["llama3.2-3b", "rwkv6-1.6b",
                                  "musicgen-medium"])
def test_prefill_step_matches_reference(name):
    jcfg, cfg, jtree, params = _setup(name)
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, size=(3, 96)).astype(np.int32)
        tx = torch.from_numpy(x).long()
    else:
        x = rng.normal(size=(3, 96, cfg.d_model)).astype(np.float32)
        tx = torch.from_numpy(x)
    h, _ = JT.forward(jtree, jcfg, jnp.asarray(x))
    want = np.asarray(JT.unembed(jtree, jcfg, h[:, -1:, :])[:, 0],
                      np.float32)
    got = make_prefill_step(cfg, device="cpu")(params, {"inputs": tx})
    assert got.dtype == torch.float32 and got.shape == (3,
                                                        cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_serve_step_factory_matches_reference_and_checks_batch():
    jcfg, cfg, jtree, params = _setup("qwen3-32b", seed=1)
    shape = InputShape("decode_b2", 32, 2, "decode")
    step = make_serve_step(cfg, "cpu", shape)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    jcache = _jax_cache(jcfg, 2, 32)
    tokens = np.array([[3], [11]], np.int32)
    for pos in range(4):
        want, jcache = JT.serve_step(jtree, jcfg, jcache,
                                     jnp.asarray(tokens + pos), pos)
        got, cache = step(params, cache, torch.from_numpy(tokens + pos),
                          pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="batch"):
        step(params, cache, torch.zeros((3, 1), dtype=torch.long), 4)


def test_transformer_backend_matches_reference_token_stream():
    """Five dispatches of 8 requests through ``predict`` equal the same
    token stream through the reference's ``serve_step``; a second width
    keeps its own cache and position."""
    jcfg = jax_get_config("llama3.2-3b").reduced(n_layers=2, d_model=64)
    jtree = _jax_init(jcfg, 0)
    cfg = get_config("llama3.2-3b").reduced(n_layers=2, d_model=64)
    params = transformer_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, jtree), device="cpu")
    be = TransformerBackend(seq_len=16, device="cpu")
    be.params = params
    assert be.cfg == cfg and not be.has_labels
    jcache = _jax_cache(jcfg, 8, 16)
    rng = np.random.default_rng(0)
    for pos in range(5):
        samples = rng.integers(0, 10 ** 6, size=8)
        assert be.predict(0, None, samples) is None
        tokens = jnp.asarray(samples % cfg.vocab_size, jnp.int32)[:, None]
        want, jcache = JT.serve_step(jtree, jcfg, jcache, tokens, pos)
        np.testing.assert_allclose(be.last_logits.numpy(),
                                   np.asarray(want), rtol=TOL, atol=TOL)
    for i, block in enumerate(be._caches[8]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                block["sub0"][key].numpy(),
                np.asarray(jcache["sub0"][key][i]), rtol=TOL, atol=TOL)
    be.predict(0, None, np.arange(4))
    assert be._pos == {8: 5, 4: 1}


def test_transformer_backend_position_wraps_and_donate_false_keeps_cache():
    be = TransformerBackend(seq_len=3, device="cpu", donate=False)
    be.predict(0, None, np.arange(2))
    first = be._caches[2][0]["sub0"]["k"]
    snapshot = first.clone()
    be.predict(0, None, np.arange(2))
    torch.testing.assert_close(first, snapshot)
    assert not torch.equal(be._caches[2][0]["sub0"]["k"], snapshot)
    be.predict(0, None, np.arange(2))
    assert be._pos[2] == 0
    assert torch.isfinite(be.last_logits).all()


def test_cnn_backend_serves_live_params():
    """Argmax of the live trainer's params, equal to the reference
    model's on the same params; a later install is served at once."""
    jparams, japply = jax_cnn.build_model("mnist", jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    _, apply = cnn.build_model("mnist", 0, torch.device("cpu"))
    trainer = types.SimpleNamespace(params=params_from_jax(np_params, "cpu"),
                                    apply_fn=apply,
                                    device=torch.device("cpu"))
    be = CNNBackend([trainer])
    x = np.random.default_rng(0).normal(size=(16, 28, 28, 1)).astype(
        np.float32)
    got = be.predict(0, x, np.arange(16))
    want = np.asarray(jnp.argmax(japply(jparams, jnp.asarray(x)), -1))
    np.testing.assert_array_equal(got, want)
    trainer.params, _ = cnn.build_model("mnist", 1, torch.device("cpu"))
    with torch.no_grad():
        fresh = apply(trainer.params, torch.from_numpy(x)).argmax(-1)
    np.testing.assert_array_equal(be.predict(0, x, np.arange(16)),
                                  fresh.numpy())


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("llama3.2-3b").reduced(n_layers=2, d_model=64)
    for make in (lambda: make_prefill_step(cfg),
                 lambda: make_serve_step(cfg),
                 lambda: TransformerBackend(),
                 lambda: T.init_params(cfg),
                 lambda: T.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
