"""Parity of the port's wkv6 op with the reference's.

The same numpy inputs go through the reference's Pallas kernel in
interpret mode and its jnp oracle, and through the port's plain versions
(``ref.wkv``, ``ref.wkv_chunked``, ``ref.wkv_step``) and its dispatcher
on the CPU, over the reference's sweep and tolerance
(``tests/test_kernels.py``: 1e-4).  The CUDA kernel itself runs only on
a card: its tests are in ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import kernel as jax_kernel, ref as jax_ref
from repro_torch.kernels.wkv6 import kernel, ops, ref


def _inputs(b, h, t, d, seed=0, w_lo=0.7, zeros=False):
    """``zeros``: every 5th step of every 3rd channel decays fully."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, h, t, d)).astype(np.float32)
    k = (rng.normal(size=(b, h, t, d)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, h, t, d)).astype(np.float32)
    w = rng.uniform(w_lo, 0.999, size=(b, h, t, d)).astype(np.float32)
    if zeros:
        w[:, :, ::5, ::3] = 0.0
    u = (rng.normal(size=(h, d)) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,h,t,d,chunk", [
    (1, 1, 32, 8, 8), (2, 3, 64, 16, 16), (1, 2, 128, 64, 128),
    (2, 2, 96, 32, 32),
])
def test_port_matches_reference_kernel(b, h, t, d, chunk):
    arrays = _inputs(b, h, t, d)
    ja = [jnp.asarray(a) for a in arrays]
    want_kernel = np.asarray(jax_kernel.wkv(*ja, chunk=chunk,
                                            interpret=True))
    want_ref = np.asarray(jax_ref.wkv(*ja))
    ta = _torch(arrays)
    gots = [ref.wkv(*ta), ops.wkv(*ta)]
    if t % chunk == 0:
        gots.append(ref.wkv_chunked(*ta, chunk=chunk))
    for got in gots:
        assert got.dtype == torch.float32 and got.shape == ta[0].shape
        np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-4,
                                   atol=1e-4)


def test_dispatcher_takes_chunked_form_for_long_sequences():
    """T = 256 sends the CPU dispatcher to ``wkv_chunked(chunk=64)``,
    as the reference's; both agree with the scan oracle."""
    arrays = _inputs(1, 2, 256, 16, seed=5, w_lo=0.9)
    ta = _torch(arrays)
    got = ops.wkv(*ta)
    want = jax_ref.wkv_chunked(*[jnp.asarray(a) for a in arrays], chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), ref.wkv(*ta).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bf16_matches_reference():
    """bf16 inputs: both sides upcast to f32 and round the result once,
    so they differ by one bf16 rounding (2**-8 relative) at most."""
    arrays = _inputs(1, 2, 32, 16, seed=6)
    ja = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    want = np.asarray(jax_ref.wkv(*ja), np.float32)
    got = ops.wkv(*[t.to(torch.bfloat16) for t in _torch(arrays)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2e-2, atol=2e-2)


def test_decode_step_consistency():
    """Running T decode steps == the full-sequence recurrence, and each
    step equals the reference's ``wkv_step``."""
    arrays = _inputs(1, 2, 24, 8, seed=1, w_lo=0.8)
    r, k, v, w, u = _torch(arrays)
    full = ref.wkv(r, k, v, w, u)
    s = torch.zeros((1, 2, 8, 8))
    js = jnp.zeros((1, 2, 8, 8), jnp.float32)
    jr, jk, jv, jw, ju = (jnp.asarray(a) for a in arrays)
    outs = []
    for i in range(24):
        s, o = ops.wkv_step(s, r[:, :, i], k[:, :, i], v[:, :, i],
                            w[:, :, i], u)
        js, jo = jax_ref.wkv_step(js, jr[:, :, i], jk[:, :, i],
                                  jv[:, :, i], jw[:, :, i], ju)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                                   atol=1e-4)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, 2).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_full_decay_property():
    """With w=0 the state resets every step: o_t = r_t @ (u*k_t v_t^T +
    k_{t-1} v_{t-1}^T)."""
    rng = np.random.default_rng(2)
    r, k, v = (torch.from_numpy(rng.normal(size=(1, 1, 8, 4)).astype(
        np.float32)) for _ in range(3))
    w = torch.zeros((1, 1, 8, 4))
    u = torch.from_numpy(rng.normal(size=(1, 4)).astype(np.float32))
    out = ops.wkv(r, k, v, w, u).numpy()
    rn, kn, vn, un = r.numpy(), k.numpy(), v.numpy(), u.numpy()
    for i in range(1, 8):
        expected = rn[0, 0, i] @ (
            un[0][:, None] * np.outer(kn[0, 0, i], vn[0, 0, i])
            + np.outer(kn[0, 0, i - 1], vn[0, 0, i - 1]))
        np.testing.assert_allclose(out[0, 0, i], expected, rtol=1e-4,
                                   atol=1e-4)


def test_cpu_tensor_never_launches():
    ta = _torch(_inputs(1, 1, 16, 8))
    before = kernel.wkv.launches
    ops.wkv(*ta)
    assert kernel.wkv.launches == before


def test_kernel_wrapper_rejects_cpu_tensor():
    ta = _torch(_inputs(1, 1, 16, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv(*ta)


# strong decays, w in [0, 0.999] with exact zeros: a chunk's decay product
# underflows, where a factorisation through r * P_excl and k / P_incl
# fails (the reference's chunked form is off by up to ~3.7 there)
@pytest.mark.parametrize("b,h,t,d,chunk", [
    (1, 2, 256, 16, 64), (2, 2, 200, 8, 64), (1, 3, 130, 32, 64),
    (1, 1, 17, 16, 64), (1, 2, 96, 64, 16),
])
def test_chunked_form_matches_scan_at_strong_decays(b, h, t, d, chunk):
    """f32: ``wkv_chunked`` (any T: a ragged last chunk is padded) against
    the port's and the reference's step-by-step oracles at the
    reference's tolerance."""
    arrays = _inputs(b, h, t, d, seed=t + d, w_lo=0.0, zeros=True)
    ta = _torch(arrays)
    got = ref.wkv_chunked(*ta, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ta[0].shape
    np.testing.assert_allclose(got.numpy(), ref.wkv(*ta).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ref.wkv(*map(jnp.asarray, arrays))),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("t", [256, 200])
def test_chunked_form_bf16_inputs_at_strong_decays(t):
    """bf16 inputs: both sides upcast the same values and sum in f32, so
    they differ by the rounding of the result to bf16 at most."""
    ta = [x.to(torch.bfloat16)
          for x in _torch(_inputs(2, 2, t, 16, seed=9, w_lo=0.0,
                                  zeros=True))]
    got = ref.wkv_chunked(*ta, chunk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               ref.wkv(*ta).to(torch.float32).numpy(),
                               rtol=2e-2, atol=2e-2)


def test_dispatcher_chunked_form_at_strong_decays():
    """The CPU dispatcher's chunked path (T >= 256) at decays down to 0,
    against the port's and the reference's step-by-step oracles."""
    arrays = _inputs(1, 2, 256, 16, seed=11, w_lo=0.0, zeros=True)
    ta = _torch(arrays)
    got = ops.wkv(*ta).numpy()
    np.testing.assert_allclose(got, ref.wkv(*ta).numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_ref.wkv(*map(jnp.asarray, arrays))), rtol=1e-4,
        atol=1e-4)


# ---------------------------------------------------------------------------
# gradients on the CPU --------------------------------------------------------
# ---------------------------------------------------------------------------
# The CPU dispatcher differentiates the plain versions with autograd; their
# gradients (of r, k, v, w and u) against ``jax.grad`` of the reference's
# scan oracle on the same inputs and output gradient, 1e-4 x (1 + |grad|):
# the same f32 products summed in other orders.  The backward kernels on
# the card are held to these plain versions in
# ``test_torch_kernels_cuda.py``.
GRAD_TOL = 1e-4


def _grads_both(arrays, dout, fn):
    _, vjp = jax.vjp(jax_ref.wkv, *[jnp.asarray(a) for a in arrays])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(dout))
    return [g.numpy() for g in got], want


def _assert_grads(got, want):
    for name, g, w in zip("rkvwu", got, want):
        assert g.shape == w.shape
        assert np.all(np.abs(g - w) <= GRAD_TOL * (1 + np.abs(w))), (
            name, float(np.abs(g - w).max()))


@pytest.mark.parametrize("b,h,t,d", [(1, 1, 32, 8), (2, 3, 64, 16),
                                     (1, 2, 128, 64), (2, 2, 96, 32)])
@pytest.mark.parametrize("zeros", [False, True])
def test_gradients_match_reference_oracle(b, h, t, d, zeros):
    """The scan the dispatcher takes below T = 256, also with decays of
    exactly 0."""
    arrays = _inputs(b, h, t, d, seed=20, w_lo=0.0 if zeros else 0.7,
                     zeros=zeros)
    dout = np.random.default_rng(21).normal(size=(b, h, t, d)).astype(
        np.float32)
    got, want = _grads_both(arrays, dout, ops.wkv)
    _assert_grads(got, want)


def test_chunked_gradient_matches_reference_oracle():
    """T = 256 sends the dispatcher to ``wkv_chunked``: its gradient
    against ``jax.grad`` of the reference's scan, at mild decays."""
    arrays = _inputs(1, 2, 256, 16, seed=22, w_lo=0.9)
    dout = np.random.default_rng(23).normal(size=(1, 2, 256, 16)).astype(
        np.float32)
    got, want = _grads_both(arrays, dout, ops.wkv)
    _assert_grads(got, want)
    got_chunk, _ = _grads_both(arrays, dout, lambda *x: ref.wkv_chunked(
        *x, chunk=32))
    _assert_grads(got_chunk, want)


def test_backward_wrapper_rejects_cpu_tensor():
    r, k, v, w, u = _torch(_inputs(1, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.wkv_backward(r, k, v, w, u, r)
