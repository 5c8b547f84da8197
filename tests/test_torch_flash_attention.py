"""Parity of the port's flash_attention op with the reference's.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode and its jnp oracle, and through the port's plain versions
(``ref.attention``, ``ref.blocked_attention``) and its dispatcher on the
CPU, over the reference's sweep and tolerances (``tests/test_kernels.py``:
f32 2e-5, bf16 5e-2).  The CUDA kernel itself runs only on a card: its
tests are in ``test_torch_kernels_cuda.py``.  What this file can say of
the card's bf16 kernels is their arithmetic: ``_tensor_core_emulation``
(the forward, with the rows' log-sum-exp it writes) and
``_tensor_core_backward_emulation`` (the backward) repeat it in plain
torch and are held to the tolerances the card's tests use.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jax_kernel
from repro.kernels.flash_attention import ref as jax_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

SWEEP = [(1, 2, 2, 128, 32),      # MHA
         (2, 4, 2, 256, 64),      # GQA 2:1
         (1, 8, 1, 128, 64),      # MQA
         (2, 4, 4, 512, 16)]


def _inputs(b, hq, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _np(x):
    return np.asarray(x.to(torch.float32).numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d", SWEEP)
@pytest.mark.parametrize("window", [None, 64])
def test_port_matches_reference_kernel_f32(b, hq, hkv, s, d, window):
    arrays = _inputs(b, hq, hkv, s, d)
    q, k, v = _jax(arrays, "float32")
    want_kernel = jax_kernel.flash_attention(q, k, v, causal=True,
                                             window=window, block_q=64,
                                             block_k=64, interpret=True)
    want_ref = jax_ref.attention(q, k, v, causal=True, window=window)
    tq, tk, tv = _torch(arrays, "float32")
    for got in (ref.attention(tq, tk, tv, causal=True, window=window),
                ref.blocked_attention(tq, tk, tv, causal=True,
                                      window=window, block=64),
                ops.attention(tq, tk, tv, causal=True, window=window)):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        np.testing.assert_allclose(_np(got), _np(want_kernel), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(_np(got), _np(want_ref), rtol=2e-5,
                                   atol=2e-5)


def test_port_matches_reference_kernel_bf16():
    arrays = _inputs(1, 2, 2, 128, 64)
    q, k, v = _jax(arrays, "bfloat16")
    want = jax_kernel.flash_attention(q, k, v, block_q=64, block_k=64,
                                      interpret=True)
    tq, tk, tv = _torch(arrays, "bfloat16")
    for got in (ref.attention(tq, tk, tv), ops.attention(tq, tk, tv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), rtol=5e-2,
                                   atol=5e-2)


def test_window_one_returns_v():
    """Property: with window=1 each row attends only to itself."""
    q, k, v = _torch(_inputs(1, 1, 1, 128, 16, seed=3), "float32")
    for got in (ops.attention(q, k, v, causal=True, window=1),
                ref.blocked_attention(q, k, v, causal=True, window=1,
                                      block=64)):
        np.testing.assert_allclose(got[0, 0].numpy(), v[0, 0].numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_blocked_matches_exact_and_reference_at_4096():
    """S = 4096 sends the CPU dispatcher to the blocked form."""
    arrays = _inputs(1, 2, 1, 4096, 32, seed=2)
    tq, tk, tv = _torch(arrays, "float32")
    got = ops.attention(tq, tk, tv, causal=True)
    exact = ref.attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2e-5,
                               atol=2e-5)
    q, k, v = _jax(arrays, "float32")
    want = jax_ref.blocked_attention(q, k, v, causal=True, block=1024)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5,
                               atol=2e-5)


def test_blocked_non_causal_window_and_block_that_does_not_divide():
    """Non-causal with a window (row r sees the keys c > r - window) in
    blocks of 32 equals the exact form; a block that does not divide S
    raises."""
    q, k, v = _torch(_inputs(1, 1, 1, 128, 16, seed=4), "float32")
    got = ref.blocked_attention(q, k, v, causal=False, window=16, block=32)
    want = ref.attention(q, k, v, causal=False, window=16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError):
        ref.blocked_attention(q, k, v, block=48)


def test_cpu_tensor_never_launches():
    q, k, v = _torch(_inputs(1, 2, 1, 64, 16), "float32")
    before = kernel.flash_attention.launches
    ops.attention(q, k, v)
    assert kernel.flash_attention.launches == before


def test_kernel_wrapper_rejects_cpu_tensor():
    q, k, v = _torch(_inputs(1, 2, 1, 64, 16), "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention(q, k, v)


def _tensor_core_emulation(q, k, v, causal=True, window=None, block=128,
                           return_lse=False):
    """The bf16 tensor-core kernel's arithmetic in plain torch: bf16
    inputs, f32 scores, an online softmax over tiles of ``block`` keys
    whose probabilities are rounded to bf16 before P.V, f32 accumulation
    and row sums of the unrounded probabilities, one bf16 rounding of
    the output.  With ``return_lse`` also each row's log-sum-exp as the
    kernel writes it (base 2: the max of the scaled scores plus log2 of
    the row sum; -inf for a row with no key)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hq, s, 1), -1e30)
    l = torch.zeros((b, hq, s, 1))
    acc = torch.zeros((b, hq, s, d))
    for c0 in range(0, s, block):
        cols = torch.arange(c0, min(c0 + block, s))[None, :]
        ok = torch.ones(s, cols.shape[1], dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= cols > rows - window
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, c0:c0 + block])
        x = (x * scale_log2).masked_fill(~ok, -1e30)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        p = torch.exp2(x - m_new).masked_fill(~ok, 0.0)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            vf[:, :, c0:c0 + block])
        m = m_new
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(
        torch.bfloat16)
    if not return_lse:
        return out
    lse = torch.where(l == 0, torch.full_like(l, -math.inf),
                      m + torch.log2(l))
    return out, lse[..., 0]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 2, 1, 2048, 128, True, None),   # llama3.2-3b's head dim and length
    (1, 2, 1, 200, 64, True, None),     # ragged: no 128-key tile divides S
    (1, 2, 2, 200, 64, True, 64),
    (1, 2, 1, 129, 128, False, None),
])
def test_tensor_core_arithmetic_holds_card_tolerance(b, hq, hkv, s, d,
                                                     causal, window):
    """The bf16 kernel rounds P to bf16 before P.V where the reference
    keeps it in f32: its arithmetic, emulated here, stays within the
    card's bf16 tolerance 1e-2 x (1 + |out|) of the port's plain version
    and of the reference's oracle on the same bf16 inputs."""
    arrays = _inputs(b, hq, hkv, s, d, seed=5)
    tq, tk, tv = _torch(arrays, "bfloat16")
    got = _np(_tensor_core_emulation(tq, tk, tv, causal=causal,
                                     window=window))
    q, k, v = _jax(arrays, "bfloat16")
    for want in (_np(ref.attention(tq, tk, tv, causal=causal,
                                   window=window)),
                 _np(jax_ref.attention(q, k, v, causal=causal,
                                       window=window))):
        assert np.all(np.abs(got - want) <= 1e-2 * (1 + np.abs(want)))


# ---------------------------------------------------------------------------
# gradients on the CPU --------------------------------------------------------
# ---------------------------------------------------------------------------
# The CPU dispatcher differentiates the plain versions with autograd; their
# gradients against ``jax.grad`` of the reference's oracle on the same
# inputs and output gradient.  f32: the same products summed in other
# orders (einsums, softmax reductions): 1e-4 x (1 + |grad|).  The backward
# kernels on the card are held to these plain versions in
# ``test_torch_kernels_cuda.py``.
GRAD_TOL = 1e-4


def _jax_grads(fn, arrays, dout):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _torch_grads(fn, arrays, dout):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(out, leaves,
                                                   torch.from_numpy(dout))]


def _assert_grads(got, want, tol=GRAD_TOL):
    for g, w in zip(got, want):
        assert np.all(np.abs(g - w) <= tol * (1 + np.abs(w))), (
            float(np.abs(g - w).max()))


@pytest.mark.parametrize("b,hq,hkv,s,d", SWEEP)
@pytest.mark.parametrize("window", [None, 64])
def test_gradients_match_reference_oracle(b, hq, hkv, s, d, window):
    arrays = _inputs(b, hq, hkv, s, d, seed=11)
    dout = np.random.default_rng(12).normal(size=(b, hq, s, d)).astype(
        np.float32)
    want = _jax_grads(lambda q, k, v: jax_ref.attention(
        q, k, v, causal=True, window=window), arrays, dout)
    for fn in (ops.attention, lambda q, k, v, **kw: ref.blocked_attention(
            q, k, v, block=64, **kw)):
        got = _torch_grads(lambda q, k, v: fn(q, k, v, causal=True,
                                              window=window), arrays, dout)
        _assert_grads(got, want)


def test_blocked_gradient_at_4096_matches_reference():
    """S = 4096 sends the CPU dispatcher to the blocked form, whose
    KV-block step is checkpointed; its gradient against ``jax.grad`` of
    the reference's blocked form (also checkpointed)."""
    arrays = _inputs(1, 2, 1, 4096, 16, seed=13)
    dout = np.random.default_rng(14).normal(size=(1, 2, 4096, 16)).astype(
        np.float32)
    want = _jax_grads(lambda q, k, v: jax_ref.blocked_attention(
        q, k, v, causal=True, block=1024), arrays, dout)
    got = _torch_grads(lambda q, k, v: ops.attention(q, k, v, causal=True),
                       arrays, dout)
    _assert_grads(got, want)


def test_blocked_gradient_recomputes_each_block():
    """The checkpoint recomputes each block's step in backward: the step's
    einsum over keys runs twice per block under grad, once without."""
    q, k, v = (torch.tensor(a, requires_grad=True)
               for a in _inputs(1, 1, 1, 256, 16, seed=15))
    calls = []
    real = torch.einsum

    def counted(eq, *args):
        if eq == "bhqd,bhkd->bhqk":
            calls.append(1)
        return real(eq, *args)

    torch.einsum = counted
    try:
        out = ref.blocked_attention(q, k, v, block=64)
        forward_calls = len(calls)
        out.sum().backward()
    finally:
        torch.einsum = real
    assert forward_calls == 4 and len(calls) == 8
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def test_backward_wrapper_rejects_cpu_tensor():
    q, k, v = _torch(_inputs(1, 2, 1, 64, 16), "float32")
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.flash_attention_backward(q, k, v, q, lse, q)


# ---------------------------------------------------------------------------
# the rows' log-sum-exp and the tensor-core backward's arithmetic -----------
# ---------------------------------------------------------------------------
LOG2E = math.log2(math.e)


def _jax_row_lse(q, k, causal, window):
    """``jax.nn.logsumexp`` of the reference's scaled, masked scores, in
    base 2."""
    b, hq, s, d = q.shape
    kr = jnp.repeat(k, hq // k.shape[1], axis=1)
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, kr) / math.sqrt(d)
    rows, cols = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    ok = jnp.ones((s, s), bool)
    if causal:
        ok = ok & (cols <= rows)
    if window is not None:
        ok = ok & (cols > rows - window)
    return np.asarray(jax.nn.logsumexp(jnp.where(ok, scores, -jnp.inf),
                                       axis=-1)) * LOG2E


@pytest.mark.parametrize("b,hq,hkv,s,d", SWEEP)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None), (False, 50)])
def test_row_lse_matches_reference_logsumexp(b, hq, hkv, s, d, causal,
                                            window):
    """``ref.row_lse`` (what the forward kernels write for the backward)
    against ``jax.nn.logsumexp`` of the reference's scaled scores, in
    base 2, f32: 1e-5 x (1 + |lse|) (the same sums in other orders); and
    the bf16 kernel's arithmetic (``_tensor_core_emulation``) against it
    on the same bf16 inputs."""
    arrays = _inputs(b, hq, hkv, s, d, seed=17)
    tq, tk, _ = _torch(arrays, "float32")
    got = ref.row_lse(tq, tk, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b, hq, s)
    want = _jax_row_lse(*_jax(arrays[:2], "float32"), causal, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    bq, bk, bv = _torch(arrays, "bfloat16")
    _, lse = _tensor_core_emulation(bq, bk, bv, causal=causal,
                                    window=window, return_lse=True)
    np.testing.assert_allclose(
        lse.numpy(), ref.row_lse(bq, bk, causal=causal,
                                 window=window).numpy(), rtol=1e-5,
        atol=1e-5)


def test_row_lse_window_one_is_own_score():
    """Property: with window=1 each row sees only its own key, so its
    log-sum-exp is its own scaled score in base 2."""
    q, k, _ = _torch(_inputs(1, 2, 1, 128, 16, seed=18), "float32")
    own = (q * k).sum(dim=-1) / math.sqrt(16) * LOG2E
    np.testing.assert_allclose(ref.row_lse(q, k, window=1).numpy(),
                               own.numpy(), rtol=1e-5, atol=1e-5)


def _tensor_core_backward_emulation(q, k, v, do, causal=True, window=None):
    """The bf16 backward kernels' arithmetic in plain torch: bf16 inputs,
    the forward's (emulated) bf16 output and log-sum-exp, delta =
    rowsum(do o) in f32 from the bf16 output, f32 scores S and dP,
    P = 2^(S log2(e) / sqrt(D) - lse) and dZ = P (dP - delta) in f32; dZ
    rounded to bf16 as the A operand of dQ = dZ K, P and dZ as bf16 high
    and low parts (hi = bf16(x), lo = bf16(x - hi)) as the A operands of
    dV = P^T dO and dK = dZ^T Q; f32 sums, dK and dV summed over the group
    in f32, one bf16 rounding of each gradient."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    o, lse = _tensor_core_emulation(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    scale = 1.0 / math.sqrt(d)
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None, :]
    ok = torch.ones(s, s, dtype=torch.bool)
    if causal:
        ok &= cols <= rows
    if window is not None:
        ok &= cols > rows - window
    x = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (LOG2E * scale)
    p = torch.exp2(x - lse[..., None]).masked_fill(~ok, 0.0)
    dz = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    def hi_lo(t):
        hi = t.to(torch.bfloat16).float()
        return hi, (t - hi).to(torch.bfloat16).float()

    (p_hi, p_lo), (z_hi, z_lo) = hi_lo(p), hi_lo(dz)
    dq = torch.einsum("bhqk,bhkd->bhqd", z_hi, kf) * scale
    dk = (torch.einsum("bhqk,bhqd->bhkd", z_hi, qf)
          + torch.einsum("bhqk,bhqd->bhkd", z_lo, qf))
    dv = (torch.einsum("bhqk,bhqd->bhkd", p_hi, dof)
          + torch.einsum("bhqk,bhqd->bhkd", p_lo, dof))
    dk, dv = (t.view(b, hkv, group, s, d).sum(dim=2) for t in (dk, dv))
    return [t.to(torch.bfloat16) for t in (dq, dk * scale, dv)]


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 2, 1, 2048, 128, True, None),   # llama3.2-3b's head dim and length
    (1, 2, 1, 200, 64, True, None),     # ragged: no 64- or 128-row tile
    (1, 2, 2, 200, 64, True, 64),
    (1, 2, 1, 129, 128, False, None),
])
def test_tensor_core_backward_arithmetic_holds_card_tolerance(
        b, hq, hkv, s, d, causal, window):
    """The bf16 backward kernels round dZ to bf16 before dQ's product and
    split P and dZ into bf16 high and low parts for dV's and dK's, where
    the CUDA-core kernels keep them in f32, and read the forward's bf16
    output (delta) and log-sum-exp: their arithmetic,
    emulated here, stays within the card's bf16 tolerance 2e-2 x
    (1 + |grad|) of ``jax.vjp`` of the reference's oracle and of the
    port's autograd through ``ref.attention``, both in f32 on the same
    bf16 values."""
    arrays = _inputs(b, hq, hkv, s, d, seed=19)
    dout = np.random.default_rng(20).normal(size=(b, hq, s, d)).astype(
        np.float32)
    tq, tk, tv, tdo = _torch([*arrays, dout], "bfloat16")
    got = [_np(g) for g in _tensor_core_backward_emulation(
        tq, tk, tv, tdo, causal=causal, window=window)]
    values = [_np(t) for t in (tq, tk, tv)]
    do32 = _np(tdo)
    want_jax = _jax_grads(lambda q, k, v: jax_ref.attention(
        q, k, v, causal=causal, window=window), values, do32)
    want_port = _torch_grads(lambda q, k, v: ref.attention(
        q, k, v, causal=causal, window=window), values, do32)
    for want in (want_jax, want_port):
        _assert_grads(got, want, tol=2e-2)
