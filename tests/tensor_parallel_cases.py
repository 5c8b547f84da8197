"""Shared cases of the ``tests/test_torch_tensor_parallel*.py`` files:
tensor and FSDP parallelism of the transformer steps on DTensor, on
spawned ``gloo`` ranks on the CPU, held to the reference's unsharded
steps.  One file a mesh, so that each stays short on one worker.

The reference's own mesh paths are red under jax 0.9, so its oracle is
its unsharded path under ``jax.jit``: ``make_train_step``, ``forward``
(last-token logits) and ``serve_step``.  Both packages get the same
converted params (``convert.transformer_params_from_jax``) and the same
NumPy inputs, in float32.  A mesh is one spawn
(``launch/spawn.py::run_ranks``) that runs every config on the port's
DTensor steps (``make_sharded_train_step``, ``make_prefill_step``,
``make_serve_step`` with ``mesh=``); rank 0 gathers the results whole.
Tolerance 1e-4 x (1 + |x|):
  * configs: llama3.2-3b cut as the reference's ``MINI_DRYRUN``
    (``tests/test_sharding.py``: 2 layers, d_model 128, batch 8 x 128),
    rwkv6-1.6b, deepseek-v2-lite-16b (MLA + MoE; its decode at
    ``capacity_factor`` 11, as the reference's flat-vs-grouped test) and
    jamba (Mamba + attention + MoE; the reference's scan per step,
    ``mamba_scan_chunk`` 0), each reduced, batch 8 x 64;
  * one train step (every param and the three metrics), the prefill
    logits, and 4 decode steps' logits at the mesh's decode batch: 8 is
    too small to split over ``data`` by the production tables, so the
    caches split their sequence over ``("data", "model")``; at 16 the
    batch splits over ``data`` and the sequence over ``model``.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.launch.spawn import run_ranks

TOL = 1e-4
LR = 0.1
DECODE_STEPS = 4
DECODE_LEN = 16
NAMES = ["llama3.2-3b", "rwkv6-1.6b", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b"]
FL_SEQ, FL_BATCH = 64, 2
# llama cuts whose heads do not split evenly over a model axis of 2
# (``layers.attention_layout``): 4 q heads over 1 kv head, each rank's 2
# q heads reading it ("kv_per_rank"), and 3 q heads ("gathered")
HEAD_LAYOUTS = {"kv_per_rank": {"n_heads": 4, "n_kv_heads": 1},
                "gathered": {"n_heads": 3, "n_kv_heads": 1, "d_model": 96,
                             "d_head": 32}}


def _cfg(get_config, name, decode=False):
    """The reduced config of ``name`` (a config or a ``HEAD_LAYOUTS``
    key) in either package (``get_config`` is the package's); ``decode``
    raises deepseek's capacity."""
    if name in HEAD_LAYOUTS:
        cfg = dataclasses.replace(
            get_config("llama3.2-3b").reduced(n_layers=2, d_model=128),
            **HEAD_LAYOUTS[name])
    elif name == "llama3.2-3b":
        cfg = get_config(name).reduced(n_layers=2, d_model=128)
    else:
        cfg = get_config(name).reduced()
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    if decode and cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=11.0)
    return cfg


def _shape(name):
    return (128, 8) if name == "llama3.2-3b" else (64, 8)


def check_head_layout(ranks, name):
    """The layout the cut ``name`` took on a model axis of 2."""
    recorded = ranks[0]["configs"][name]["layouts"]
    assert [v["layout"] for v in recorded.values()] == [name], recorded


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    else:
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return x, rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _torch(x):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.long() if t.dtype == torch.int32 else t


def _jax_tree(name, seed=1):
    """The reference's params for ``name`` (numpy), built under jit."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as JT
    jcfg = _cfg(jax_get_config, name)
    tree = jax.jit(JT.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the ranks' side: imports only the port
# ---------------------------------------------------------------------------
def _gather(x):
    from repro_torch.sharding.activations import to_global
    return to_global(x).detach().float().cpu().numpy().copy()


def _place(step, tree, what="place"):
    """``step.place(tree)`` (or ``place_cache``) on a mesh; from a step
    made with ``mesh=None`` a copy of ``tree`` (``place`` copies too: a
    donated step must not write into the caller's tensors)."""
    from repro_torch.tree import tree_map
    return getattr(step, what, lambda t: tree_map(torch.clone, t))(tree)


def _rank_configs(rank, mesh, trees, decode_batch, layouts=(),
                  device="cpu"):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.convert import (transformer_params_from_jax,
                                     transformer_params_to_numpy)
    from repro_torch.launch.serve import make_serve_step
    from repro_torch.launch.train import (make_prefill_step,
                                          make_sharded_train_step)
    from repro_torch.models import transformer as T
    from repro_torch.sharding import activations as A
    from repro_torch.tree import tree_map
    out = {}
    for name in NAMES + list(layouts):
        cfg = _cfg(get_config, name)
        seq, batch = _shape(name)
        x, y = _inputs(cfg, batch, seq, seed=2)
        params = transformer_params_from_jax(cfg, trees[name], device=device)
        rec = {}
        pre = make_prefill_step(cfg, device=device, mesh=mesh)
        rec["prefill"] = _gather(pre(_place(pre, params),
                                     {"inputs": _torch(x).to(device)}))
        rec["layouts"] = A.layouts()
        step = make_sharded_train_step(cfg, InputShape("tp", seq, batch,
                                                       "train"),
                                       lr=LR, device=device, mesh=mesh)
        new, metrics = step(_place(step, params),
                            {"inputs": _torch(x).to(device),
                             "labels": _torch(y).to(device)})
        rec["train"] = (transformer_params_to_numpy(
            cfg, tree_map(lambda t: torch.from_numpy(_gather(t)), new)),
            {k: float(v) for k, v in metrics.items()})
        dcfg = _cfg(get_config, name, decode=True)
        for b in (decode_batch,) if name in NAMES else ():
            xd, _ = _inputs(dcfg, b, DECODE_STEPS, seed=3)
            sv = make_serve_step(dcfg, device=device, mesh=mesh,
                                 shape=InputShape("d", DECODE_LEN, b,
                                                  "decode"))
            cache = _place(sv, T.init_cache(dcfg, b, DECODE_LEN,
                                            device=device), "place_cache")
            placed = _place(sv, params)
            logits = []
            for pos in range(DECODE_STEPS):
                lg, cache = sv(placed, cache,
                               _torch(xd[:, pos:pos + 1]).to(device), pos)
                logits.append(_gather(lg))
            rec[f"decode{b}"] = np.stack(logits)
        out[name] = rec
    return out if rank == 0 else None


def _fl_case(rank, trees, device="cpu"):
    """The pod FL step on (pod 2, data 1, model 2): each pod one replica
    (the two replicas' params differ), sharded over ``model``; two
    local steps a round."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.convert import (transformer_params_from_jax,
                                     transformer_params_to_numpy)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.tree import tree_map
    cfg = _cfg(get_config, "llama3.2-3b")
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device=device)
    pod = mesh.get_coordinate()[0]
    x, y = _inputs(cfg, 2 * FL_BATCH, FL_SEQ, seed=4)
    reps = [transformer_params_from_jax(cfg, trees[key], device=device)
            for key in ("fl0", "fl1")]
    step = make_fl_train_step(cfg, 2, InputShape("fl", FL_SEQ,
                                                 2 * FL_BATCH, "train"),
                              lr=LR, h_local=2, device=device, mesh=mesh)
    mine = step.place(tree_map(lambda t: t[None].clone(), reps[pod]))
    rows = slice(pod * FL_BATCH, (pod + 1) * FL_BATCH)
    new, metrics = step(mine, {"inputs": _torch(x[None, rows]).to(device),
                               "labels": _torch(y[None, rows]).to(device)})
    got = transformer_params_to_numpy(
        cfg, tree_map(lambda t: torch.from_numpy(_gather(t)[0]), new))
    return got, {k: float(v) for k, v in metrics.items()}


def _ranks_main(rank, world, shape, trees, decode_batch, fl, layouts,
                device="cpu"):
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    if device == "cuda":
        _tf32_off()
    mesh = make_mesh(shape, ("data", "model"), device=device)
    out = {"shape": shape, "decode_batch": decode_batch,
           "configs": _rank_configs(rank, mesh, trees, decode_batch,
                                    layouts, device)}
    if fl:
        out["fl"] = _fl_case(rank, trees, device)
    return out


def _tf32_off():
    """Float32 products in float32 on the card (no TF32), as on the
    CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_trees(fl=False):
    """:func:`make_trees`' layout from the port's own init (no JAX: the
    card's machine has none), seeded as :func:`make_trees` seeds."""
    from repro_torch.configs import get_config
    from repro_torch.convert import transformer_params_to_numpy
    from repro_torch.models import transformer as T

    def tree(name, seed):
        cfg = _cfg(get_config, name)
        return transformer_params_to_numpy(
            cfg, T.init_params(cfg, seed=seed, device="cpu"))

    out = {name: tree(name, 1) for name in NAMES}
    if fl:
        out["fl0"] = tree("llama3.2-3b", 5)
        out["fl1"] = tree("llama3.2-3b", 6)
    return out


def make_trees(fl=False, layouts=False):
    """The reference's params of every config (numpy), with ``fl`` two
    llama replicas for the FL step, with ``layouts`` the
    ``HEAD_LAYOUTS`` cuts."""
    out = {name: _jax_tree(name)
           for name in NAMES + (list(HEAD_LAYOUTS) if layouts else [])}
    if fl:
        out["fl0"] = _jax_tree("llama3.2-3b", seed=5)
        out["fl1"] = _jax_tree("llama3.2-3b", seed=6)
    return out


def spawn(shape, trees, tmp_path_factory, decode_batch, fl=False,
          layouts=(), backend="gloo", device="cpu"):
    """Every rank's results on a ``shape`` ("data", "model") mesh (the
    ``layouts`` cuts: prefill and train step only), its ranks in a
    ``backend`` group on ``device``."""
    d = tmp_path_factory.mktemp(f"tp_{shape[0]}x{shape[1]}")
    return run_ranks(_ranks_main, shape[0] * shape[1], d / "store",
                     (shape, trees, decode_batch, fl, tuple(layouts),
                      device), backend=backend, device=device, timeout=600)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
_REFERENCE = {}


def _jax_cfg(name):
    from repro.configs import get_config as jax_get_config
    jcfg = _cfg(jax_get_config, name)
    if jcfg.attn_every:
        jcfg = dataclasses.replace(jcfg, mamba_scan_chunk=0)
    return jcfg


def _reference(name, trees, decode_batch):
    """The reference's unsharded prefill logits, train step and decode
    logits (at ``decode_batch``) for ``name``, under jax.jit, each
    computed once in a process."""
    import jax
    import jax.numpy as jnp
    from repro.models import transformer as JT
    jcfg = _jax_cfg(name)
    tree = jax.tree_util.tree_map(jnp.asarray, trees[name])
    if name not in _REFERENCE:
        seq, batch = _shape(name)
        x, y = _inputs(jcfg, batch, seq, seed=2)

        def prefill(p, inputs):
            h, _ = JT.forward(p, jcfg, inputs)
            return JT.unembed(p, jcfg, h[:, -1:, :])[:, 0].astype(
                jnp.float32)

        rec = {"prefill": np.asarray(jax.jit(prefill)(tree, x))}
        new, metrics = jax.jit(JT.make_train_step(jcfg, lr=LR))(
            tree, {"inputs": x, "labels": y})
        rec["train"] = (jax.tree_util.tree_map(np.asarray, new),
                        {k: float(v) for k, v in metrics.items()})
        _REFERENCE[name] = rec
    rec = _REFERENCE[name]
    key = f"decode{decode_batch}"
    if key not in rec:
        dcfg = dataclasses.replace(jcfg, capacity_factor=11.0) \
            if jcfg.n_experts else jcfg
        serve = jax.jit(lambda p, c, t, pos: JT.serve_step(p, dcfg, c, t,
                                                           pos))
        xd, _ = _inputs(dcfg, decode_batch, DECODE_STEPS, seed=3)
        cache = jax.jit(JT.init_cache, static_argnums=(0, 1, 2))(
            dcfg, decode_batch, DECODE_LEN)
        logits = []
        for pos in range(DECODE_STEPS):
            lg, cache = serve(tree, cache, xd[:, pos:pos + 1], pos)
            logits.append(np.asarray(lg))
        rec[key] = np.stack(logits)
    return rec


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def _trees_close(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _trees_close(got[k], want[k], f"{path}/{k}")
        return
    _close(np.asarray(got), np.asarray(want, dtype=np.float32), path)




def check_prefill(ranks, trees, name):
    want = _reference(name, trees, ranks[0]["decode_batch"])["prefill"]
    _close(ranks[0]["configs"][name]["prefill"], want, f"{name} prefill")


def check_train_step(ranks, trees, name):
    got, metrics = ranks[0]["configs"][name]["train"]
    want, want_metrics = _reference(name, trees,
                                    ranks[0]["decode_batch"])["train"]
    _trees_close(got, want, name)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(metrics[key], want_metrics[key],
                                   rtol=TOL, atol=TOL, err_msg=key)


def check_decode(ranks, trees, name):
    b = ranks[0]["decode_batch"]
    _close(ranks[0]["configs"][name][f"decode{b}"],
           _reference(name, trees, b)[f"decode{b}"],
           f"{name} decode at batch {b}")


def check_layouts(ranks):
    """Rank 0 records how the heads and experts sat on ``model``: at a
    model axis of 1 or 2 the reduced configs' heads (4) and experts (4)
    split evenly."""
    model = ranks[0]["shape"][1]
    for name in NAMES:
        recorded = ranks[0]["configs"][name]["layouts"]
        assert recorded, name
        for what in recorded.values():
            assert what["layout"] in ("split", "experts_split"), name
            assert what["model"] == model, name


def check_pod_fl_step(ranks, trees):
    """The (pod 2, data 1, model 2) FL round against the port's one-device
    round over both replicas, from the same params and batch: every rank
    of both pods ends with the mean."""
    want0, want_metrics = one_device_fl(trees)
    for r, rank in enumerate(ranks):
        got, metrics = rank["fl"]
        _trees_close(got, want0, f"rank {r}")
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(metrics[key], float(want_metrics[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)


def one_device_fl(trees, device="cpu"):
    """The port's one-device FL round over both llama replicas from the
    same params and batch as :func:`_fl_case`: replica 0's params (numpy)
    and the metrics."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.convert import (transformer_params_from_jax,
                                     transformer_params_to_numpy)
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.tree import tree_map
    cfg = _cfg(get_config, "llama3.2-3b")
    reps = [transformer_params_from_jax(cfg, trees[k], device=device)
            for k in ("fl0", "fl1")]
    stacked = tree_map(lambda a, b: torch.stack([a, b]), *reps)
    x, y = _inputs(cfg, 2 * FL_BATCH, FL_SEQ, seed=4)
    step = make_fl_train_step(cfg, 2, InputShape("fl", FL_SEQ, 2 * FL_BATCH,
                                                 "train"),
                              lr=LR, h_local=2, device=device)
    want, metrics = step(stacked, {
        "inputs": _torch(x.reshape(2, FL_BATCH, FL_SEQ)).to(device),
        "labels": _torch(y.reshape(2, FL_BATCH, FL_SEQ)).to(device)})
    want0 = transformer_params_to_numpy(
        cfg, tree_map(lambda t: t[0].cpu(), want))
    return want0, {k: float(v) for k, v in metrics.items()}


def one_device(trees, decode_batch, device="cpu"):
    """The port's own steps at ``mesh=None`` on ``device``, recorded as
    rank 0 records its mesh's (``ranks[0]["configs"]``)."""
    if device == "cuda":
        _tf32_off()
    return _rank_configs(0, None, trees, decode_batch, (), device)


def check_against(ranks, want, name):
    """Rank 0's prefill, train step (every param, the three metrics) and
    decode for ``name`` within ``TOL`` of ``want[name]``
    (:func:`one_device`'s)."""
    got, want = ranks[0]["configs"][name], want[name]
    b = ranks[0]["decode_batch"]
    _close(got["prefill"], want["prefill"], f"{name} prefill")
    _trees_close(got["train"][0], want["train"][0], name)
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(got["train"][1][key],
                                   want["train"][1][key], rtol=TOL,
                                   atol=TOL, err_msg=key)
    _close(got[f"decode{b}"], want[f"decode{b}"],
           f"{name} decode at batch {b}")
