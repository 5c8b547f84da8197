"""The port's CUDA kernels on the card, against their plain versions.

These tests carry the ``cuda`` marker and skip where no CUDA device is
visible (a CUDA kernel has no CPU mode).  They import neither JAX nor
the reference package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fedavg_agg import kernel, ops, ref
from repro_torch.kernels.flash_attention import (
    kernel as fa_kernel, ops as fa_ops, ref as fa_ref)
from repro_torch.kernels.wkv6 import (
    kernel as wkv_kernel, ops as wkv_ops, ref as wkv_ref)

# the reference's sweep (tests/test_kernels.py), the MNIST CNN's largest
# leaf at the paper setup's 68 clients, and a ragged width
SHAPES = [(1, 7), (3, 100), (5, 128, 33), (2, 16384), (4, 3, 5, 7),
          (68, 3136, 128), (3, 1001)]
DTYPES = [("float32", 1e-6), ("bfloat16", 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's CUDA kernels have no "
                    "CPU mode)")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, size=shape[0]).astype(
        np.float32))
    return (x.to(device=device, dtype=getattr(torch, dtype)),
            (w / w.sum()).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fedavg_agg_matches_plain_version(cuda_device, shape, dtype, tol):
    x, w = _inputs(shape, dtype, cuda_device)
    before = kernel.weighted_aggregate.launches
    got = ops.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    assert kernel.weighted_aggregate.launches == before + 1
    want = ref.weighted_aggregate(x, w)
    assert got.dtype == x.dtype and got.shape == x.shape[1:]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_fedavg_agg_unaligned_rows(cuda_device):
    """A view starting one element in is not 16-byte aligned: the
    kernel takes its scalar path and still agrees."""
    base, w = _inputs((3 * 64 + 1,), "float32", cuda_device)
    x = base[1:].view(3, 64)
    w = torch.full((3,), 1 / 3, device=cuda_device)
    got = kernel.weighted_aggregate(x, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref.weighted_aggregate(x, w).cpu().numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_fedavg_agg_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 10), device=cuda_device)
    w = torch.full((4,), 0.25, device=cuda_device)
    with pytest.raises(TypeError):
        kernel.weighted_aggregate(x.double(), w)
    with pytest.raises(ValueError):
        kernel.weighted_aggregate(x.t(), w)
    with pytest.raises(ValueError):
        kernel.weighted_aggregate(x, w[:3])
    with pytest.raises(ValueError):
        kernel.weighted_aggregate(x, w.double())


# the MNIST CNN's eight leaves (paper setup) and one that no 4-element
# vector divides
MNIST_LEAVES = [(32,), (32, 1, 3, 3), (64,), (64, 32, 3, 3), (128,),
                (3136, 128), (10,), (128, 10)]


def _bucket_stacks(leaves, split, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    parts = [[torch.from_numpy(rng.normal(size=(c,) + shape).astype(
                 np.float32)).to(device=device, dtype=getattr(torch, dtype))
              for shape in leaves] for c in split]
    w = rng.uniform(0.1, 1.0, size=sum(split)).astype(np.float32)
    return parts, torch.from_numpy(w / w.sum()).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [MNIST_LEAVES, [(7,), (1001,), (3, 5)]])
@pytest.mark.parametrize("split", [(64, 4), (1, 1), (68,)])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fedavg_agg_many_leaves_one_launch(cuda_device, leaves, split, dtype,
                                           tol):
    """Every leaf over every bucket in one launch, against the plain
    version on the concatenated stacks; the same bits on a second call
    (the block's partial sums are added in a fixed order)."""
    parts, w = _bucket_stacks(leaves, split, dtype, cuda_device)
    before = kernel.weighted_aggregate.launches
    got = ops.aggregate(parts, w)
    again = ops.aggregate(parts, w)
    torch.cuda.synchronize()
    assert kernel.weighted_aggregate.launches == before + 2
    want = ref.aggregate(parts, w)
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   c.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_fedavg_agg_many_leaves_unaligned_bucket(cuda_device):
    """One bucket's stack starts one element in (not 16-byte aligned):
    that leaf takes the scalar path, the others stay vectorized."""
    parts, w = _bucket_stacks([(64,), (3136, 128)], (3, 2), "float32",
                              cuda_device)
    base = torch.zeros(2 * 64 + 1, device=cuda_device)
    base[1:] = parts[1][0].flatten()
    parts[1][0] = base[1:].view(2, 64)
    got = kernel.aggregate(parts, w)
    torch.cuda.synchronize()
    for a, c in zip(got, ref.aggregate(parts, w)):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_fedavg_agg_many_leaves_most_clients(cuda_device):
    """12,288 clients over two buckets: the weights fill the shared
    memory the kernel opts in to."""
    parts, w = _bucket_stacks([(5,), (300,), (1030,)], (12000, 288),
                              "float32", cuda_device)
    got = kernel.aggregate(parts, w)
    torch.cuda.synchronize()
    for a, c in zip(got, ref.aggregate(parts, w)):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_fedavg_agg_vgg11_over_three_buckets(cuda_device, dtype, tol):
    """VGG-11's 18 leaves over three width buckets, as a round with
    skewed pools makes them, in one launch."""
    from repro_torch.models import cnn
    from repro_torch.tree import tree_leaves
    leaves = [tuple(t.shape) for t in tree_leaves(
        cnn.init_vgg11(torch.Generator().manual_seed(0)))]
    parts, w = _bucket_stacks(leaves, (3, 2, 1), dtype, cuda_device)
    before = kernel.weighted_aggregate.launches
    got = kernel.aggregate(parts, w)
    torch.cuda.synchronize()
    assert kernel.weighted_aggregate.launches == before + 1
    for a, c in zip(got, ref.aggregate(parts, w)):
        np.testing.assert_allclose(a.float().cpu().numpy(),
                                   c.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_fedavg_agg_fullest_table(cuda_device):
    """584 leaves over two buckets: the table fills the 32 KB of kernel
    parameters, and one leaf more is refused."""
    leaves = [(1 + i % 7, 1 + i % 300) for i in range(584)]
    parts, w = _bucket_stacks(leaves, (2, 1), "float32", cuda_device)
    got = kernel.aggregate(parts, w)
    torch.cuda.synchronize()
    for a, c in zip(got, ref.aggregate(parts, w)):
        np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="at most"):
        kernel.aggregate([p + p[:1] for p in parts], w)


# ---------------------------------------------------------------------------
# flash_attention -------------------------------------------------------------
# ---------------------------------------------------------------------------
# the reference's sweep (tests/test_kernels.py), llama3.2-3b's head dim
# (also over 32 KV tiles, as in its prefill), a ragged sequence length
# that no 64-row tile divides, qwen3-moe's GQA group of 16 at head dim
# 128 (64 query heads over 4 KV heads there) and jamba's group of 8 (64
# over 8)
FLASH_SHAPES = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 128, 64),
                (2, 4, 4, 512, 16), (1, 6, 2, 256, 128),
                (1, 4, 2, 2048, 128), (2, 4, 2, 200, 64),
                (1, 16, 1, 256, 128), (1, 8, 1, 256, 128)]
# bf16: kernel and plain version both sum in f32 from the same bf16
# inputs and round the output once; the kernel (on the tensor cores) also
# rounds the probabilities to bf16 before P.V, as FA2/FA3 do.  They differ
# by about two bf16 roundings (2**-8 relative each); 1e-2 covers it with
# room and is well below the outputs' own size (|out| ~ 0.03 and up for
# these random inputs)
FLASH_TOLERANCE = [("float32", 2e-5), ("bfloat16", 1e-2)]


def _normal(rng, shape, device, dtype, scale=1.0):
    x = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return x.to(device=device, dtype=getattr(torch, dtype))


def _assert_close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype,tol", FLASH_TOLERANCE)
def test_flash_attention_matches_plain_version(cuda_device, b, hq, hkv, s,
                                               d, window, dtype, tol):
    rng = np.random.default_rng(0)
    q = _normal(rng, (b, hq, s, d), cuda_device, dtype)
    k = _normal(rng, (b, hkv, s, d), cuda_device, dtype)
    v = _normal(rng, (b, hkv, s, d), cuda_device, dtype)
    before = fa_kernel.flash_attention.launches
    got = fa_ops.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _assert_close(got, fa_ref.attention(q, k, v, causal=True,
                                        window=window), tol)


def _flash_bf16_case(device, b, hq, hkv, s, d, causal, window, seed=0):
    """One bf16 call of the tensor-core kernel against the plain version
    at 1e-2 x (1 + |out|); the C entry point must count it as a
    tensor-core launch."""
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, hq, s, d), device, "bfloat16")
    k = _normal(rng, (b, hkv, s, d), device, "bfloat16")
    v = _normal(rng, (b, hkv, s, d), device, "bfloat16")
    before = fa_kernel.variant_launches()
    got = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = fa_kernel.variant_launches()
    assert after["tensor_cores"] == before["tensor_cores"] + 1
    assert after["cuda_cores"] == before["cuda_cores"]
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _assert_close(got, fa_ref.attention(q, k, v, causal=causal,
                                        window=window), 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 129, 200])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_bf16_ragged_sequence(cuda_device, s, d):
    """S that no 128-row tile divides: TMA zero-fills the rows past S."""
    _flash_bf16_case(cuda_device, 2, 4, 2, s, d, True, None, seed=s + d)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 1, 64, 100])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_bf16_window(cuda_device, window, d):
    _flash_bf16_case(cuda_device, 1, 4, 2, 300, d, True, window, seed=d)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("window", [None, 50])
def test_flash_attention_bf16_non_causal(cuda_device, d, window):
    _flash_bf16_case(cuda_device, 1, 4, 2, 200, d, False, window, seed=d)


@pytest.mark.cuda
def test_flash_attention_bf16_llama_gqa(cuda_device):
    """llama3.2-3b's 24 q-heads over 8 kv heads at its prefill length."""
    _flash_bf16_case(cuda_device, 1, 24, 8, 2048, 128, True, None, seed=7)


@pytest.mark.cuda
def test_flash_attention_float32_stays_on_cuda_cores(cuda_device):
    rng = np.random.default_rng(8)
    q, k, v = (_normal(rng, (1, 2, 96, 64), cuda_device, "float32")
               for _ in range(3))
    before = fa_kernel.variant_launches()
    fa_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    after = fa_kernel.variant_launches()
    assert after["cuda_cores"] == before["cuda_cores"] + 1
    assert after["tensor_cores"] == before["tensor_cores"]


@pytest.mark.cuda
def test_flash_attention_window_one_returns_v(cuda_device):
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, (1, 1, 128, 16), cuda_device, "float32")
               for _ in range(3))
    got = fa_kernel.flash_attention(q, k, v, causal=True, window=1)
    torch.cuda.synchronize()
    _assert_close(got, v, 1e-5)


@pytest.mark.cuda
def test_flash_attention_non_causal_matches_plain_version(cuda_device):
    rng = np.random.default_rng(4)
    q = _normal(rng, (1, 4, 200, 32), cuda_device, "float32")
    k, v = (_normal(rng, (1, 2, 200, 32), cuda_device, "float32")
            for _ in range(2))
    got = fa_kernel.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    _assert_close(got, fa_ref.attention(q, k, v, causal=False), 2e-5)


@pytest.mark.cuda
def test_flash_attention_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 4, 64, 64), device=cuda_device)
    k = torch.zeros((1, 2, 64, 64), device=cuda_device)
    with pytest.raises(TypeError):
        fa_kernel.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q[..., :48].contiguous(),
                                  k[..., :48].contiguous(),
                                  k[..., :48].contiguous())
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q, torch.zeros((1, 3, 64, 64),
                                                 device=cuda_device), k)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention(q, k, k.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# wkv6 ------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# the reference's sweep (tests/test_kernels.py), rwkv6-1.6b's head dim
# and a ragged sequence length that no 32-step chunk divides
WKV_SHAPES = [(1, 1, 32, 8), (2, 3, 64, 16), (1, 2, 128, 64),
              (2, 2, 96, 32), (2, 4, 200, 64)]


# f32: the reference's 1e-4.  bf16: the inputs are the same bf16 values
# on both sides and both sum in f32; the outputs differ by the rounding of
# the result to bf16 (2**-8 relative) and, on the tensor cores, by the
# bf16 high and low parts of the factored operands (~2**-17 of the
# state's size): 2e-2 covers both with room
WKV_TOLERANCE = [("float32", 1e-4), ("bfloat16", 2e-2)]


def _wkv_inputs(shape, device, dtype, seed=0, w_lo=0.7, k_scale=0.3,
                w_hi=0.999):
    """w_lo = 0: decays from [0, 0.999] with exact zeros (every 5th step
    of every 3rd channel)."""
    b, h, t, d = shape
    rng = np.random.default_rng(seed)
    r = _normal(rng, shape, device, dtype)
    k = _normal(rng, shape, device, dtype, k_scale)
    v = _normal(rng, shape, device, dtype)
    w = rng.uniform(w_lo, w_hi, size=shape).astype(np.float32)
    if w_lo == 0.0:
        w[:, :, ::5, ::3] = 0.0
    w = torch.from_numpy(w).to(device=device, dtype=getattr(torch, dtype))
    u = _normal(rng, (h, d), device, dtype, 0.1)
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("w_lo", [0.7, 0.0])
@pytest.mark.parametrize("dtype,tol", WKV_TOLERANCE)
def test_wkv6_matches_plain_version(cuda_device, shape, w_lo, dtype, tol):
    r, k, v, w, u = _wkv_inputs(shape, cuda_device, dtype, w_lo=w_lo)
    before = wkv_kernel.wkv.launches
    got = wkv_ops.wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv_kernel.wkv.launches == before + 1
    assert got.dtype == r.dtype and got.shape == r.shape
    _assert_close(got, wkv_ref.wkv(r, k, v, w, u), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 17, 200, 2048])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype,tol", WKV_TOLERANCE)
def test_wkv6_strong_decays(cuda_device, t, d, dtype, tol):
    """Decays down to exact zeros, where a chunk's decay product
    underflows: ragged and long sequences, every head dim, both kernels
    (bf16 at D >= 16 on the tensor cores)."""
    r, k, v, w, u = _wkv_inputs((2, 2, t, d), cuda_device, dtype,
                                seed=t + d, w_lo=0.0)
    got = wkv_kernel.wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    assert got.dtype == r.dtype and got.shape == r.shape
    _assert_close(got, wkv_ref.wkv(r, k, v, w, u), tol)


@pytest.mark.cuda
def test_wkv6_rejects_what_it_does_not_take(cuda_device):
    r, k, v, w, u = _wkv_inputs((1, 2, 16, 16), cuda_device, "float32")
    with pytest.raises(TypeError):
        wkv_kernel.wkv(r.double(), k.double(), v.double(), w.double(),
                       u.double())
    with pytest.raises(ValueError):
        wkv_kernel.wkv(r, k, v, w, u.to(torch.bfloat16))
    with pytest.raises(ValueError):
        wkv_kernel.wkv(r, k, v, w, u[:1])
    with pytest.raises(ValueError):
        wkv_kernel.wkv(r.transpose(2, 3), k, v, w, u)
    r2, k2, v2, w2, u2 = _wkv_inputs((1, 2, 16, 128), cuda_device,
                                     "float32")
    with pytest.raises(ValueError):
        wkv_kernel.wkv(r2, k2, v2, w2, u2)


# ---------------------------------------------------------------------------
# backward kernels ------------------------------------------------------------
# ---------------------------------------------------------------------------
# Each backward kernel against autograd through its plain version on the
# card, on the same input values, the oracle in float32 (bf16 inputs
# widened exactly): autograd in bf16 would round every contribution to a
# gradient of an input used at many steps (wkv's u) to bf16 before
# summing them.  f32: both sum f32 products in other orders (the kernels
# per tile, autograd per einsum); 1e-4 x (1 + |grad|).  bf16: the kernel
# sums in f32 and rounds each gradient to bf16 once (2**-8 relative); the
# attention kernels (tensor cores) also round P and dZ to bf16 as the
# operands of their products and read the forward's bf16-rounded output
# for delta: 2e-2 x (1 + |grad|) holds a gradient summed over 2048 rows
# relative to its own size (the arithmetic emulated on the CPU reaches
# 0.30 of it, tests/test_torch_flash_attention.py).
GRAD_TOLERANCE = [("float32", 1e-4), ("bfloat16", 2e-2)]


def _assert_grads_close(got, want, tol, names):
    for name, a, b in zip(names, got, want):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        err = (a - b).abs()
        bound = tol * (1 + b.abs())
        assert bool((err <= bound).all()), (
            f"{name}: max err {float(err.max()):.3g}, worst ratio "
            f"{float((err / bound).max()):.3g}")


def _grads(fn, inputs, dout):
    """Gradients of ``fn(*inputs)`` against ``dout``; zeros for an input
    the output does not depend on (wkv's last decay)."""
    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, dout, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, grads)]


def _flash_backward_case(device, b, hq, hkv, s, d, causal, window, dtype,
                         tol, seed=0):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, hq, s, d), device, dtype)
    k = _normal(rng, (b, hkv, s, d), device, dtype)
    v = _normal(rng, (b, hkv, s, d), device, dtype)
    dout = _normal(rng, (b, hq, s, d), device, dtype)
    before = fa_kernel.flash_attention_backward.launches
    got = _grads(lambda *x: fa_ops.attention(*x, causal=causal,
                                             window=window), (q, k, v),
                 dout)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_backward.launches == before + 1
    want = _grads(lambda *x: fa_ref.attention(*x, causal=causal,
                                              window=window),
                  [x.float() for x in (q, k, v)], dout.float())
    for g, x in zip(got, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _assert_grads_close(got, want, tol, ("dq", "dk", "dv"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype,tol", GRAD_TOLERANCE)
def test_flash_attention_backward_matches_autograd(cuda_device, b, hq, hkv,
                                                   s, d, window, dtype, tol):
    _flash_backward_case(cuda_device, b, hq, hkv, s, d, True, window, dtype,
                         tol)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 63, 65, 200])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,tol", GRAD_TOLERANCE)
def test_flash_attention_backward_ragged_sequence(cuda_device, s, d, dtype,
                                                  tol):
    """S that no 64-row tile divides: the tiles' rows past S see no key
    and must give nothing, not NaN, to any gradient."""
    _flash_backward_case(cuda_device, 2, 4, 2, s, d, True, None, dtype, tol,
                         seed=s + d)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 1), (True, 100),
                                           (False, None), (False, 50)])
@pytest.mark.parametrize("dtype,tol", GRAD_TOLERANCE)
def test_flash_attention_backward_masks(cuda_device, causal, window, dtype,
                                        tol):
    """Window 1 (each row sees only itself), a window that no tile
    divides, and the non-causal masks."""
    _flash_backward_case(cuda_device, 1, 4, 2, 300, 64, causal, window,
                         dtype, tol, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
def test_flash_attention_backward_llama_gqa(cuda_device, b):
    """llama3.2-3b's 24 q-heads over 8 kv heads at its training length:
    dk and dv sum three query heads over 2048 rows, on the tensor-core
    kernels."""
    before = fa_kernel.backward_variant_launches()
    _flash_backward_case(cuda_device, b, 24, 8, 2048, 128, True, None,
                         "bfloat16", 2e-2, seed=7)
    after = fa_kernel.backward_variant_launches()
    assert after["tensor_cores"] == before["tensor_cores"] + 1
    assert after["cuda_cores"] == before["cuda_cores"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (2, 4, 2, 300, 64, None), (2, 6, 2, 333, 16, 100),
    (2, 6, 2, 333, 32, None), (2, 6, 2, 333, 128, 100)])
def test_flash_attention_backward_is_deterministic(cuda_device, b, hq, hkv,
                                                   s, d, window):
    """Two bf16 backward calls on the same inputs give the same dq, dk
    and dv, bit for bit: no atomics, the GQA sum in a fixed order."""
    rng = np.random.default_rng(9)
    q = _normal(rng, (b, hq, s, d), cuda_device, "bfloat16")
    k, v = (_normal(rng, (b, hkv, s, d), cuda_device, "bfloat16")
            for _ in range(2))
    o, lse = fa_kernel.flash_attention(q, k, v, window=window,
                                       return_lse=True)
    dout = _normal(rng, q.shape, cuda_device, "bfloat16")
    first = fa_kernel.flash_attention_backward(q, k, v, o, lse, dout,
                                               window=window)
    second = fa_kernel.flash_attention_backward(q, k, v, o, lse, dout,
                                                window=window)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_flash_attention_backward_rejects_what_it_does_not_take(
        cuda_device):
    q = torch.zeros((1, 4, 64, 64), device=cuda_device)
    k = torch.zeros((1, 2, 64, 64), device=cuda_device)
    lse = torch.zeros((1, 4, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention_backward(q, k, k, q, lse,
                                           q.transpose(2, 3))
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_backward(q, k, k, q[:, :2], lse, q)
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_backward(*(t.double()
                                             for t in (q, k, k, q)), lse,
                                           q.double())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [("bfloat16", "tensor_cores"),
                                           ("float32", "cuda_cores")])
def test_flash_attention_backward_variant(cuda_device, dtype, variant):
    """bf16 runs on the tensor-core kernels, f32 on the CUDA cores, as the
    backward's C entry point counts them."""
    rng = np.random.default_rng(10)
    q = _normal(rng, (1, 4, 200, 64), cuda_device, dtype)
    k, v = (_normal(rng, (1, 2, 200, 64), cuda_device, dtype)
            for _ in range(2))
    o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True)
    dout = _normal(rng, q.shape, cuda_device, dtype)
    before = fa_kernel.backward_variant_launches()
    fa_kernel.flash_attention_backward(q, k, v, o, lse, dout)
    torch.cuda.synchronize()
    after = fa_kernel.backward_variant_launches()
    other = "cuda_cores" if variant == "tensor_cores" else "tensor_cores"
    assert after[variant] == before[variant] + 1
    assert after[other] == before[other]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 4, 2, 200, 64, True, None), (2, 4, 4, 65, 16, True, 64),
    (1, 6, 2, 129, 32, False, None), (1, 24, 8, 2048, 128, True, None),
    (1, 16, 1, 256, 128, True, None), (1, 8, 1, 256, 128, True, None)])
def test_flash_attention_forward_lse(cuda_device, dtype, b, hq, hkv, s, d,
                                     causal, window):
    """The forward with the log-sum-exp buffer gives the same output, bit
    for bit, as without it; its log-sum-exp is within 1e-5 of
    ``ref.row_lse`` (the same f32 sums of the same bf16 or f32 inputs,
    in other orders)."""
    rng = np.random.default_rng(s)
    q = _normal(rng, (b, hq, s, d), cuda_device, dtype)
    k, v = (_normal(rng, (b, hkv, s, d), cuda_device, dtype)
            for _ in range(2))
    plain = fa_kernel.flash_attention(q, k, v, causal=causal, window=window)
    out, lse = fa_kernel.flash_attention(q, k, v, causal=causal,
                                         window=window, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    want = fa_ref.row_lse(q, k, causal=causal, window=window)
    assert float((lse - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_flash_attention_backward_bf16_refusal_raises(cuda_device):
    """A bf16 call the kernels cannot take raises before launching
    anything and never falls back to another design."""
    rng = np.random.default_rng(12)
    q = _normal(rng, (1, 4, 64, 64), cuda_device, "bfloat16")
    k = _normal(rng, (1, 2, 64, 64), cuda_device, "bfloat16")
    o, lse = fa_kernel.flash_attention(q, k, k, return_lse=True)
    torch.cuda.synchronize()
    before = (fa_kernel.backward_variant_launches(),
              fa_kernel.flash_attention_backward.launches)
    odd = _normal(rng, (1, 4, 64, 48), cuda_device, "bfloat16")
    odd_kv = _normal(rng, (1, 2, 64, 48), cuda_device, "bfloat16")
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention_backward(odd, odd_kv, odd_kv, odd, lse,
                                           odd)
    with pytest.raises(ValueError, match="lse"):
        fa_kernel.flash_attention_backward(q, k, k, o, lse.bfloat16(), o)
    with pytest.raises(ValueError, match="lse"):
        fa_kernel.flash_attention_backward(q, k, k, o, lse[:, :2], o)
    with pytest.raises(ValueError, match="lse"):
        fa_kernel.flash_attention_backward(q, k, k, o, lse.cpu(), o)
    # a shape the C entry point refuses: the wrapper raises on its code
    launch = fa_kernel.build_backward()
    rc = launch(q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(),
                o.data_ptr(), q.data_ptr(), k.data_ptr(), k.data_ptr(),
                lse.data_ptr(), lse.data_ptr(), 1, 4, 2, 64, 48, 1, -1, 1,
                torch.cuda.current_stream().cuda_stream)
    assert rc != 0
    torch.cuda.synchronize()
    assert (fa_kernel.backward_variant_launches(),
            fa_kernel.flash_attention_backward.launches) == before


def _wkv_backward_case(device, shape, dtype, tol, seed=0, w_lo=0.7,
                       **scale):
    r, k, v, w, u = _wkv_inputs(shape, device, dtype, seed=seed, w_lo=w_lo,
                                **scale)
    dout = _normal(np.random.default_rng(seed + 1), shape, device, dtype)
    before = wkv_kernel.wkv_backward.launches
    got = _grads(wkv_ops.wkv, (r, k, v, w, u), dout)
    torch.cuda.synchronize()
    assert wkv_kernel.wkv_backward.launches == before + 1
    # the step-by-step scan is the oracle; at long T its chunked twin
    plain = wkv_ref.wkv if shape[2] <= 256 else wkv_ref.wkv_chunked
    want = _grads(plain, [x.float() for x in (r, k, v, w, u)],
                  dout.float())
    for g, x in zip(got, (r, k, v, w, u)):
        assert g.dtype == x.dtype and g.shape == x.shape
    _assert_grads_close(got, want, tol, ("dr", "dk", "dv", "dw", "du"))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("w_lo", [0.7, 0.0])
@pytest.mark.parametrize("dtype,tol", GRAD_TOLERANCE)
def test_wkv6_backward_matches_autograd(cuda_device, shape, w_lo, dtype,
                                        tol):
    _wkv_backward_case(cuda_device, shape, dtype, tol, w_lo=w_lo)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 17, 65, 200, 1000])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype,tol", GRAD_TOLERANCE)
def test_wkv6_backward_strong_decays(cuda_device, t, d, dtype, tol):
    """Decays down to exact zeros, lengths that no 64- or 8-step chunk
    divides, every head dim: dw comes from recomputed states, never from
    dividing by a decay."""
    _wkv_backward_case(cuda_device, (2, 2, t, d), dtype, tol, seed=t + d,
                       w_lo=0.0)


@pytest.mark.cuda
def test_wkv6_backward_rwkv_shape(cuda_device):
    """rwkv6-1.6b's head dim at its training length, decays down to 0."""
    _wkv_backward_case(cuda_device, (1, 4, 2048, 64), "bfloat16", 2e-2,
                       seed=5, w_lo=0.0)


# At rwkv6-1.6b's activation scale the state is some 30x the sweep's, and
# so is the f32 rounding of the sums over it: the f32 scan and the plain
# chunked form (two orders of the same f32 sums) differ there by more
# than 1e-4 x (1 + |grad|) (dv by 1.42x of it on an H100), and are held
# to the 2e-3 that chip_smoke.py's ``wkv_backward_kernel`` phase holds
# the f32 scan to.  bf16 as above.
WKV_ACTIVATION_GRAD_TOLERANCE = [("float32", 2e-3), ("bfloat16", 2e-2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", WKV_ACTIVATION_GRAD_TOLERANCE)
def test_wkv6_backward_rwkv_activation_scale(cuda_device, dtype, tol):
    """At the scale of rwkv6-1.6b's own activations (|k| up to ~5, decays
    from [0.99, 0.996]) the state is some 30x the synthetic sweep's; the
    bf16 kernel's error grows with the state, which its bf16 high and low
    parts keep far below the gradients' own rounding."""
    _wkv_backward_case(cuda_device, (1, 4, 2048, 64), dtype, tol, seed=6,
                       w_lo=0.99, k_scale=1.3, w_hi=0.996)


@pytest.mark.cuda
def test_wkv6_backward_rejects_what_it_does_not_take(cuda_device):
    r, k, v, w, u = _wkv_inputs((1, 2, 16, 16), cuda_device, "float32")
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv_backward(r, k, v, w, u, r.transpose(2, 3))
    with pytest.raises(ValueError):
        wkv_kernel.wkv_backward(r, k, v, w, u, r[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,variant", [
    ("bfloat16", 64, "tensor_cores"), ("bfloat16", 32, "tensor_cores"),
    ("bfloat16", 16, "tensor_cores"), ("bfloat16", 8, "cuda_cores"),
    ("float32", 64, "cuda_cores")])
@pytest.mark.parametrize("t", [1, 63, 130])
def test_wkv6_backward_design_and_determinism(cuda_device, dtype, d,
                                              variant, t):
    """bf16 at D >= 16 runs the chunked form on the tensor cores, f32 and
    bf16 at D = 8 the scan, as the backward's C entry point counts them;
    two calls on the same inputs give the same gradients, bit for bit
    (no float atomics), also at lengths no chunk divides."""
    shape = (2, 3, t, d)
    r, k, v, w, u = _wkv_inputs(shape, cuda_device, dtype, seed=t + d,
                                w_lo=0.0)
    dout = _normal(np.random.default_rng(t), shape, cuda_device, dtype)
    before = wkv_kernel.backward_variant_launches()
    got = wkv_kernel.wkv_backward(r, k, v, w, u, dout)
    torch.cuda.synchronize()
    after = wkv_kernel.backward_variant_launches()
    assert {name: after[name] - before[name] for name in after} == {
        name: int(name == variant) for name in after}
    again = wkv_kernel.wkv_backward(r, k, v, w, u, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = wkv_ref.wkv_chunked_backward(*(x.float() for x in (
        r, k, v, w, u, dout)))
    tol = dict(GRAD_TOLERANCE)[dtype]
    _assert_grads_close(got, plain, tol, ("dr", "dk", "dv", "dw", "du"))


@pytest.mark.cuda
def test_wkv6_backward_refusal_raises(cuda_device):
    """A call the kernels cannot take raises before launching anything,
    counts no launch and no design, and never falls back to another
    design."""
    r, k, v, w, u = _wkv_inputs((1, 2, 64, 64), cuda_device, "bfloat16")
    kernel_ok = wkv_kernel.wkv_backward(r, k, v, w, u, r)
    torch.cuda.synchronize()
    before = (wkv_kernel.backward_variant_launches(),
              wkv_kernel.wkv_backward.launches)
    odd = _wkv_inputs((1, 2, 64, 48), cuda_device, "bfloat16")
    with pytest.raises(ValueError, match="head dims"):
        wkv_kernel.wkv_backward(*odd, odd[0])
    with pytest.raises(ValueError):
        wkv_kernel.wkv_backward(r, k, v, w, u, r.float())
    # shapes the C entry point refuses: it returns an error code, which
    # the wrapper raises on, and launches nothing
    launch = wkv_kernel.build_backward()
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, r, *kernel_ok, r, r, r)]
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, t, d, dtype in ((1, 2, 64, 48, 1), (0, 2, 64, 64, 1),
                              (1, 2, 0, 64, 1), (1, 2, 64, 64, 2)):
        assert launch(*ptrs, b, h, t, d, dtype, stream) != 0
    torch.cuda.synchronize()
    assert (wkv_kernel.backward_variant_launches(),
            wkv_kernel.wkv_backward.launches) == before
