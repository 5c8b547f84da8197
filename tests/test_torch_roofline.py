"""The port's roofline tooling: ``launch/op_analysis.py`` (the counterpart
of the reference's ``launch/hlo_analysis.py``), ``launch/dryrun.py`` and
the ``meta`` stand-ins it runs on (``input_specs``, ``cache_specs``,
``abstract_cache``, the dispatchers' plain versions as regions).

FLOPs of the port's steps, counted on ``meta``, against the reference's
``hlo_analysis.analyze`` of its own jitted prefill and train step (the
same reduced configs, on the CPU, without a mesh).  Tolerance 1 %:
  * the dense GQA configs agree to the FLOP;
  * MoE (qwen3-moe, and deepseek's MLA + MoE) is ~0.1 % over: the port
    computes each MoE layer's router logits twice (``moe_apply`` and
    ``moe_aux_loss``), the reference's compiled HLO once (XLA merges the
    two identical dots), 2 * tokens * d_model * n_experts a layer.
RWKV6 and jamba's plain scans are another form than the reference's, and
XLA turns some of the reference's size-1 dots into multiplies (a 0.7 %
gap for RWKV6's backward), so those two are held to an analytic count of
the port's own plain form, exactly; decode likewise.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs.shapes import InputShape as JaxInputShape
from repro.launch import hlo_analysis as H
from repro.models import transformer as JT
from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, cache_specs,
                                 get_config, input_specs)
from repro_torch.kernels import region
from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
from repro_torch.kernels.fedavg_agg import ops as agg_ops
from repro_torch.kernels.fedavg_agg import ref as agg_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.wkv6 import kernel as wkv_kernel
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6 import ref as wkv_ref
from repro_torch.launch import dryrun
from repro_torch.launch import op_analysis as A
from repro_torch.launch.mesh import NVLINK_BW
from repro_torch.launch.serve import abstract_cache
from repro_torch.models import transformer as T

B, S = 2, 128
META = torch.device("meta")


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device=META, requires_grad=grad)


# ---------------------------------------------------------------------------
# parity with the reference's HLO count
# ---------------------------------------------------------------------------
def _reference_flops(name, kind):
    jcfg = jax_get_config(name).reduced()
    params = jax.eval_shape(lambda: JT.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    specs = jax_input_specs(jcfg, JaxInputShape("x", S, B, kind))
    if kind == "prefill":
        def step(p, batch):
            h, _ = JT.forward(p, jcfg, batch["inputs"])
            return JT.unembed(p, jcfg, h[:, -1:, :])[:, 0].astype(
                jnp.float32)
    else:
        step = JT.make_train_step(jcfg, lr=1e-3)
    return H.analyze(jax.jit(step).lower(params, specs).compile()
                     .as_text()).flops


def _port(name, kind, **kw):
    return dryrun.run_one(get_config(name).reduced(),
                          InputShape("x", S, B, kind), **kw)


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("name", ["llama3.2-3b", "qwen3-moe-235b-a22b",
                                  "deepseek-v2-lite-16b"])
def test_flops_equal_the_reference(name, kind):
    want = _reference_flops(name, kind)
    rec = _port(name, kind)
    got = rec["flops_per_dev"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    cfg = get_config(name).reduced()
    if not cfg.n_experts:
        assert got == want
    else:   # the router's logits, once more a MoE layer
        layers = sum(s.ffn == "moe" for s in T.block_template(cfg))
        assert got - want == 2 * B * S * cfg.d_model * cfg.n_experts \
            * layers * T.n_blocks(cfg)
    assert rec["library_cost_flops_per_dev"] == got


def _swiglu(cfg, f=None):
    return 3 * cfg.d_model * (f or cfg.d_ff)


def _gqa_proj(cfg):
    d, hd = cfg.d_model, cfg.head_dim
    return 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd


def _rwkv6_forward(cfg, head_positions):
    """The port's plain RWKV6 at T = S < 256 (the step scan): the seven
    d x d projections and the channel mix's two d x d_ff per token, one
    ``bhi,bhij->bhj`` product a step (the ``k v^T`` outer product is a
    multiply), the head."""
    d = cfg.d_model
    h = max(1, d // 64)
    per_layer = (2 * B * S * (7 * d * d + 2 * d * cfg.d_ff)
                 + 2 * B * h * (d // h) ** 2 * S)
    return (cfg.n_layers * per_layer
            + 2 * B * head_positions * d * cfg.padded_vocab)


def _jamba_forward(cfg, head_positions):
    """The port's plain jamba block (GQA or Mamba mixers, SwiGLU or MoE
    FFNs): projections per token, the plain attention's two full (S, S)
    products, the scan's contraction with C (its other products are
    multiplies), the router twice, the experts at capacity, the head."""
    d, tok = cfg.d_model, B * S
    di, st, r = cfg.expand * d, cfg.d_state, max(1, d // 16)
    e, k, f = cfg.n_experts, cfg.n_experts_active, cfg.moe_d_ff or cfg.d_ff
    cap = max(1, min(S, int(k * S / e * cfg.capacity_factor)))
    cost = {"gqa": 2 * tok * _gqa_proj(cfg)
            + 4 * B * cfg.n_heads * S * S * cfg.head_dim,
            "mamba": 2 * tok * (d * 2 * di + di * (r + 2 * st) + r * di
                                + di * d + di * st),
            "swiglu": 2 * tok * _swiglu(cfg),
            "moe": 2 * (2 * tok * d * e) + 3 * 2 * B * e * cap * d * f}
    block = sum(cost[sub.mixer] + cost[sub.ffn]
                for sub in T.block_template(cfg))
    return (T.n_blocks(cfg) * block
            + 2 * B * head_positions * d * cfg.padded_vocab)


def dryrun_mamba_layers(cfg):
    return T.n_blocks(cfg) * sum(s.mixer == "mamba"
                                 for s in T.block_template(cfg))


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_plain_scan_flops_analytic(name, kind):
    """Train = forward over every position + its backward (every product
    twice again) + the chunked Mamba scan's recompute of its forward."""
    cfg = get_config(name).reduced()
    fwd = _rwkv6_forward if name.startswith("rwkv6") else _jamba_forward
    if kind == "prefill":
        want = fwd(cfg, 1)
    else:
        want = 3 * fwd(cfg, S)
        if cfg.ssm_type == "mamba":
            assert cfg.mamba_scan_chunk and S % cfg.mamba_scan_chunk == 0
            want += (2 * B * S * cfg.expand * cfg.d_model * cfg.d_state
                     * dryrun_mamba_layers(cfg))
    rec = _port(name, kind)
    assert rec["flops_per_dev"] == want
    assert rec["library_cost_flops_per_dev"] == want


def test_decode_flops_analytic():
    """One token for B requests over a cache of L: the projections, the
    two products with the cache and the head."""
    cfg = get_config("llama3.2-3b").reduced()
    cache = 256
    rec = dryrun.run_one(cfg, InputShape("d", cache, B, "decode"))
    length = min(cache, cfg.sliding_window or cache)
    per_layer = (2 * B * (_gqa_proj(cfg) + _swiglu(cfg))
                 + 4 * B * cfg.n_heads * length * cfg.head_dim)
    want = (cfg.n_layers * per_layer
            + 2 * B * cfg.d_model * cfg.padded_vocab)
    assert rec["flops_per_dev"] == want
    assert rec["memory"]["cache_bytes"] > 0


# ---------------------------------------------------------------------------
# op_analysis on its own (mirrors tests/test_hlo_analysis.py)
# ---------------------------------------------------------------------------
def test_loop_flops_counted_every_iteration():
    n, d = 10, 256
    x, ws = _meta(d, d), _meta(n, d, d)

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x

    assert A.analyze(looped, x, ws).flops == n * 2 * d ** 3


def test_single_matmul_flops_exact():
    d = 128
    x = _meta(d, d)
    assert A.analyze(lambda x: x @ x, x).flops == 2 * d ** 3


def test_bytes_positive_and_bounded():
    d = 512
    x = _meta(d, d)
    costs = A.analyze(lambda x: torch.tanh(x @ x), x)
    # at least: read x twice + write result; at most a few round trips
    assert 3 * d * d * 4 <= costs.bytes <= 40 * d * d * 4
    # views and empty are free
    assert A.analyze(lambda x: x.t()[1:, :5].unsqueeze(0), x).bytes == 0
    assert A.analyze(lambda: torch.empty(d, d, device=META)).bytes == 0


def test_gather_reads_what_it_returns():
    table, idx = _meta(50000, 64), torch.zeros(8, dtype=torch.int64,
                                               device=META)
    costs = A.analyze(torch.nn.functional.embedding, idx, table)
    assert costs.bytes == 8 * 64 * 4 + 8 * 8


def test_costs_arithmetic():
    c = A.Costs(2.0, 10.0, {"all-reduce": 4.0})
    s = c.scaled(3)
    assert (s.flops, s.bytes, s.collectives) == (6.0, 30.0,
                                                  {"all-reduce": 12.0})
    c.add(A.Costs(1.0, 1.0, {"all-reduce": 1.0, "all-gather": 2.0}))
    assert (c.flops, c.bytes) == (3.0, 11.0)
    assert c.collectives == {"all-reduce": 5.0, "all-gather": 2.0}
    assert c.collective_total == 7.0
    assert A.Costs().collective_total == 0


MATMUL_ONLY = {
    "mm": (lambda a, b: a @ b, [(64, 96), (96, 32)]),
    "bmm": (lambda a, b: torch.bmm(a, b), [(4, 16, 8), (4, 8, 24)]),
    "addmm": (lambda c, a, b: torch.addmm(c, a, b), [(32,), (16, 8), (8, 32)]),
    "baddbmm": (lambda c, a, b: torch.baddbmm(c, a, b),
                [(3, 5, 7), (3, 5, 4), (3, 4, 7)]),
    "einsum": (lambda a, b: torch.einsum("bhqd,bhkd->bhqk", a, b),
               [(2, 3, 16, 8), (2, 3, 32, 8)]),
    "linear_backward": (lambda x, w: torch.nn.functional.linear(x, w)
                        .sum().backward(), [(8, 16), (32, 16)]),
    "conv2d_backward": (lambda x, w: torch.nn.functional.conv2d(x, w)
                        .sum().backward(), [(2, 3, 16, 16), (8, 3, 3, 3)]),
}


@pytest.mark.parametrize("case", sorted(MATMUL_ONLY))
def test_library_cost_equals_op_analysis_on_matmuls(case):
    fn, shapes = MATMUL_ONLY[case]
    args = [_meta(*s, grad=True) for s in shapes]
    flops = A.analyze(fn, *args).flops
    assert flops > 0
    assert A.library_cost(fn, *args) == {"flops": flops}
    costs, lib = A.analyze_with_library(fn, *args)
    assert costs.flops == flops and lib == {"flops": flops}


# ---------------------------------------------------------------------------
# dryrun
# ---------------------------------------------------------------------------
REFERENCE_KEYS = {"arch", "shape", "mesh", "fl_step", "fl_local",
                  "fl_agg_dtype", "status", "n_chips", "flops_per_dev",
                  "bytes_per_dev", "collective_bytes_per_dev", "memory",
                  "roofline"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "model_flops", "useful_flops_ratio"}


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
@pytest.mark.parametrize("name", ARCH_IDS)
def test_run_one_ok_for_every_arch(name, kind):
    rec = _port(name, kind)
    assert rec["status"] == "ok"
    assert REFERENCE_KEYS <= set(rec)
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["collective_bytes_per_dev"] == {"total": 0}
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["library_cost_flops_per_dev"] == rec["flops_per_dev"]
    roof = rec["roofline"]
    assert roof["bound_s"] == max(roof["t_compute_s"], roof["t_memory_s"])
    assert rec["memory"]["param_bytes"] > 0
    if kind == "train":
        assert rec["memory"]["grad_bytes"] == rec["memory"]["param_bytes"]


def test_run_one_fl_step_counts_replicas_and_aggregate():
    one = _port("llama3.2-3b", "train")
    fl = _port("llama3.2-3b", "train", fl_step=True, fl_local=2)
    assert fl["status"] == "ok" and fl["fl_step"]
    # two replicas of half the batch, two local steps each: twice the
    # one-step flops; then the aggregate, a region whose plain version is
    # one (2,) x (2, n) product a leaf
    n_params = one["memory"]["param_bytes"] // 4
    assert fl["flops_per_dev"] == (2 * one["flops_per_dev"]
                                   + 2 * 2 * n_params)


def test_mesh_single_and_multi_wait_for_the_multi_device_slice(monkeypatch,
                                                               capsys):
    """The (16, 16) and (2, 16, 16) meshes came with the tensor-parallel
    slice: both are known meshes now, nothing waits, and an unknown mesh
    still raises (the counts themselves: tests/test_torch_dryrun_mesh.py).
    """
    assert dryrun.MESHES == ("one", "single", "multi")
    assert not hasattr(dryrun, "WAITING_MESHES")
    with pytest.raises(ValueError, match="unknown mesh"):
        dryrun.run_one("llama3.2-3b", "train_4k", "ring")
    with pytest.raises(ValueError, match="multi-pod mesh"):
        dryrun.run_one("llama3.2-3b", "train_4k", "single", fl_step=True)
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "llama3.2-3b",
                                     "--shape", "train_4k", "--mesh",
                                     "ring"])
    with pytest.raises(SystemExit) as exit_:
        dryrun.main()
    assert exit_.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.fixture
def fake_group():
    """A ``"fake"`` process group of 8 ranks in this process: collectives
    dispatch and return at once, nothing is sent."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_counted_on_a_fake_group(fake_group):
    """``shard_weighted_aggregate`` over a 4-rank ``data`` axis, on
    ``meta``: one all-reduce of the params' float32 bytes (each leaf at
    an offset aligned to ``FLAT_ALIGN`` elements), and the kernel's
    region; over (data, pod) of a (2, 4) mesh the all-reduce twice.
    ``run_one``'s roofline reads the bytes over NVLink."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.fl import aggregation as agg
    from repro_torch.models import cnn
    from repro_torch.tree import tree_leaves, tree_map
    params, _ = cnn.build_model("mnist", 0, META, image_shape=(28, 28, 1))
    leaves = tree_leaves(params)
    clients = 3
    stacked = tree_map(lambda v: _meta(clients, *v.shape), params)
    weights = _meta(clients)
    n_bytes = sum(-(-v.numel() // agg.FLAT_ALIGN) * agg.FLAT_ALIGN * 4
                  for v in leaves)
    f32_bytes = sum(v.numel() * 4 for v in leaves)
    assert f32_bytes <= n_bytes < f32_bytes + len(leaves) * agg.FLAT_ALIGN * 4
    data4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    costs = A.analyze(agg.shard_weighted_aggregate, stacked, weights,
                      ("data",), data4)
    assert costs.collectives == {"all-reduce": n_bytes}
    assert costs.flops == 2 * clients * f32_bytes / 4   # the plain version
    grid = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    costs = A.analyze(agg.hierarchical_weighted_psum, params, 0.125,
                      ("data", "pod"), grid)
    assert costs.collectives == {"all-reduce": 2 * n_bytes}
    roof = dryrun.roofline({"flops": 0.0, "bytes accessed": 0.0},
                           costs.collective_total, 1,
                           get_config("llama3.2-3b"), SHAPES["train_4k"],
                           "train")
    assert roof["t_collective_s"] == 2 * n_bytes / NVLINK_BW
    assert roof["dominant"] == "collective"


def test_no_collective_on_one_device():
    costs = A.analyze(lambda x: x * 2, _meta(4))
    assert costs.collectives == {} and costs.collective_total == 0


# ---------------------------------------------------------------------------
# meta stand-ins against jax.eval_shape
# ---------------------------------------------------------------------------
def _jax_leaves(tree):
    return {jax.tree_util.keystr(path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_torch_leaves(tree[key], f"{prefix}['{key}']"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("name", ARCH_IDS)
def test_specs_and_caches_equal_eval_shape(name):
    jcfg, cfg = jax_get_config(name), get_config(name)
    for shape_name, shape in SHAPES.items():
        jshape = JaxInputShape(shape.name, shape.seq_len,
                               shape.global_batch, shape.kind)
        want = _jax_leaves(jax_input_specs(jcfg, jshape))
        got = _torch_leaves(input_specs(cfg, shape))
        assert got == want, shape_name
        assert all(t.device == META for t in input_specs(cfg, shape)
                   .values())
        if shape.kind != "decode":
            continue
        want = _jax_leaves(jax.eval_shape(
            lambda: JT.init_cache(jcfg, shape.global_batch, shape.seq_len)))
        for tree in (cache_specs(cfg, shape), abstract_cache(cfg, shape)):
            assert len(tree) == T.n_blocks(cfg)
            for block in tree:
                stacked = {k: ((len(tree),) + s, dt) for k, (s, dt)
                           in _torch_leaves(block).items()}
                assert stacked == want, shape_name


def test_specs_on_a_named_device():
    cfg = get_config("musicgen-medium").reduced()
    specs = input_specs(cfg, InputShape("x", 8, 2, "train"), device="cpu")
    assert specs["inputs"].shape == (2, 8, cfg.d_model)
    assert specs["labels"].dtype == torch.int32
    assert not specs["inputs"].any()
    cache = cache_specs(get_config("llama3.2-3b").reduced(),
                        InputShape("x", 8, 2, "decode"), device="cpu")
    assert cache[0]["sub0"]["k"].device.type == "cpu"


# ---------------------------------------------------------------------------
# the dispatchers: meta goes to the plain version, as a region
# ---------------------------------------------------------------------------
class _Regions:
    def __init__(self):
        self.names, self.bytes = [], []

    def enter_region(self, name):
        self.names.append(name)

    def exit_region(self, name, read, written):
        self.bytes.append(sum(t.numel() * t.element_size()
                              for t in (*read, *written) if t is not None))


def _refuse(*args, **kw):
    raise AssertionError("a meta tensor reached the kernel")


@pytest.fixture
def regions(monkeypatch):
    for mod, names in ((agg_kernel, ("aggregate", "weighted_aggregate")),
                       (fa_kernel, ("flash_attention",
                                    "flash_attention_backward")),
                       (wkv_kernel, ("wkv", "wkv_backward"))):
        for n in names:
            monkeypatch.setattr(mod, n, _refuse)
    rec = _Regions()
    monkeypatch.setattr(region, "LISTENERS", [rec])
    return rec


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(tuple(args[0].shape) if args else None)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


def test_meta_reaches_plain_fedavg_agg(monkeypatch, regions):
    calls = _spy(monkeypatch, agg_ref, "weighted_aggregate")
    stacked, w = _meta(4, 10, 3), _meta(4)
    out = agg_ops.weighted_aggregate(stacked, w)
    assert out.device == META and tuple(out.shape) == (10, 3)
    outs = agg_ops.aggregate([[_meta(2, 5), _meta(2, 3)],
                              [_meta(3, 5), _meta(3, 3)]], _meta(5))
    assert [tuple(o.shape) for o in outs] == [(5,), (3,)]
    assert len(calls) == 3
    assert regions.names == ["fedavg_agg", "fedavg_agg"]
    # the region's bytes: stacks and weights read once, outputs written
    assert regions.bytes[0] == (4 * 30 + 4 + 30) * 4


@pytest.mark.parametrize("seq,plain", [(128, "attention"),
                                       (4096, "blocked_attention")])
def test_meta_reaches_plain_flash_attention(monkeypatch, regions, seq,
                                            plain):
    calls = _spy(monkeypatch, fa_ref, plain)
    q = _meta(1, 4, seq, 16, grad=True)
    k, v = _meta(1, 2, seq, 16, grad=True), _meta(1, 2, seq, 16, grad=True)
    o = fa_ops.attention(q, k, v, causal=True, window=None)
    assert o.device == META and o.shape == q.shape and len(calls) == 1
    o.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert regions.names == ["flash_attention", "flash_attention_backward"]
    with torch.no_grad():
        fa_ops.attention(q, k, v)
    assert len(calls) == 2


@pytest.mark.parametrize("steps,plain", [(64, "wkv"), (256, "wkv_chunked")])
def test_meta_reaches_plain_wkv(monkeypatch, regions, steps, plain):
    calls = _spy(monkeypatch, wkv_ref, plain)
    r, k, v, w = (_meta(1, 2, steps, 16, grad=True) for _ in range(4))
    u = _meta(2, 16, grad=True)
    out = wkv_ops.wkv(r, k, v, w, u)
    assert out.device == META and out.shape == r.shape and len(calls) == 1
    out.sum().backward()
    assert u.grad.shape == u.shape and w.grad.shape == w.shape
    assert regions.names == ["wkv6", "wkv6_backward"]


def test_cpu_still_takes_the_plain_version_directly(monkeypatch, regions):
    """No region on the CPU: the numbers of the CPU path are untouched."""
    calls = _spy(monkeypatch, fa_ref, "attention")
    q = torch.randn(1, 2, 8, 4)
    out = fa_ops.attention(q, q, q)
    assert torch.equal(out, fa_ref.attention(q, q, q))
    assert len(calls) == 2 and regions.names == []


def test_region_counts_a_kernels_bytes_once():
    """Inside a region the plain version's matmuls count, its bytes do
    not: the kernel's inputs are read once and its output written once."""
    q = _meta(2, 4, 256, 32, dtype=torch.bfloat16)
    k = v = _meta(2, 2, 256, 32, dtype=torch.bfloat16)
    costs = A.analyze(fa_ops.attention, q, k, v)
    assert costs.flops == 4 * 2 * 4 * 256 * 256 * 32
    assert costs.bytes == 2 * q.numel() * 2 + 2 * k.numel() * 2
    plain = A.analyze(fa_ref.attention, q, k, v)
    assert plain.flops == costs.flops and plain.bytes > 10 * costs.bytes
