"""The plain twin of the bf16 wkv6 backward kernel on the CPU.

``ref.wkv_chunked_backward`` computes the five gradients of the RWKV6
recurrence by the chunked decomposition of ``csrc/wkv6_bwd.cu``'s
tensor-core design: boundary states a 64-step chunk at a time, their
16-step sub-chunks, then the per-sub-chunk terms, with no division by a
decay.  Here it is held, in f32, against ``jax.vjp`` of the reference's
scan oracle (``repro.kernels.wkv6.ref.wkv``) and against autograd through
the port's ``ref.wkv``, over head dims, ragged lengths and decays down to
exactly 0, at 1e-4 x (1 + |grad|) (the same f32 products summed in other
orders).  One more case rounds the tensor-core operands to bf16 high and
low parts as the kernel does, and the gradients to bf16, and holds the
result to the card's limit, 2e-2 x (1 + |grad|).  The kernel itself runs
only on a card: ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import ref as jax_ref
from repro_torch.kernels.wkv6 import ref

GRAD_TOL = 1e-4
# the card's limit for bf16 gradients (chip_smoke.WKV_GRAD_TOLERANCE)
BF16_GRAD_TOL = 2e-2


def _inputs(b, h, t, d, seed, strong, k_scale=0.3, w_range=None):
    """``strong``: decays from [0, 0.999] and exactly 0 at every 5th step
    of every 3rd channel; else from [0.7, 0.999], or from ``w_range``."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(b, h, t, d)).astype(np.float32)
    k = (rng.normal(size=(b, h, t, d)) * k_scale).astype(np.float32)
    v = rng.normal(size=(b, h, t, d)).astype(np.float32)
    lo, hi = w_range or (0.0 if strong else 0.7, 0.999)
    w = rng.uniform(lo, hi, size=(b, h, t, d)).astype(np.float32)
    if strong:
        w[:, :, ::5, ::3] = 0.0
    u = (rng.normal(size=(h, d)) * 0.1).astype(np.float32)
    dout = rng.normal(size=(b, h, t, d)).astype(np.float32)
    return [r, k, v, w, u], dout


@jax.jit
def _jax_vjp(arrays, dout):
    return jax.vjp(jax_ref.wkv, *arrays)[1](dout)


def _jax_grads(arrays, dout):
    # under jit: an eager vjp of the scan leaves jax retracing later eager
    # calls in the same process, which other tests count
    return [np.asarray(g) for g in _jax_vjp(
        [jnp.asarray(a) for a in arrays], jnp.asarray(dout))]


def _autograd(arrays, dout):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch.autograd.grad(ref.wkv(*leaves), leaves,
                              torch.from_numpy(dout), allow_unused=True)
    # at T = 1 the decay never reaches the output
    return [np.zeros_like(a) if g is None else g.numpy()
            for g, a in zip(got, arrays)]


def _worst(got, want, tol):
    """Per gradient, the largest |got - want| / (tol x (1 + |want|))."""
    return {name: float(np.max(np.abs(g - w) / (tol * (1 + np.abs(w)))))
            for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want)}


@pytest.mark.parametrize("t", [1, 16, 63, 64, 200, 256])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("strong", [False, True])
def test_chunked_backward_matches_oracles(t, d, strong):
    arrays, dout = _inputs(1, 2, t, d, seed=100 * d + t, strong=strong)
    got = ref.wkv_chunked_backward(*map(torch.from_numpy, arrays),
                                   torch.from_numpy(dout))
    got = [g.numpy() for g in got]
    for g, a in zip(got, arrays):
        assert g.dtype == np.float32 and g.shape == a.shape
    for want in (_jax_grads(arrays, dout), _autograd(arrays, dout)):
        worst = _worst(got, want, GRAD_TOL)
        assert max(worst.values()) <= 1.0, worst


def test_chunked_backward_bf16_operands_within_card_limit():
    """bf16 inputs, the tensor-core operands split into bf16 high and low
    parts and the gradients rounded to bf16, as the kernel computes them,
    against ``jax.vjp`` in f32 on the same input values: within the
    card's 2e-2 x (1 + |grad|), with room to spare."""
    arrays, dout = _inputs(1, 2, 256, 64, seed=7, strong=True)
    arrays = [torch.from_numpy(a).bfloat16() for a in arrays]
    dout = torch.from_numpy(dout).bfloat16()
    got = ref.wkv_chunked_backward(*arrays, dout, split=True)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = _jax_grads([a.float().numpy() for a in arrays],
                      dout.float().numpy())
    worst = _worst([g.float().numpy() for g in got], want, BF16_GRAD_TOL)
    print("share of the card's limit taken, by gradient:", worst)
    assert max(worst.values()) <= 0.5, worst


def test_chunked_backward_bf16_operands_at_rwkv_activation_scale():
    """As above at the scale of rwkv6-1.6b's own activations (|k| up to
    ~5, decays from [0.99, 0.996]): a state ~30x the sweep's, and the
    gradients as large, stay as far within the card's limit.  The output's
    gradient must be the same bf16 values on both sides: left unrounded
    on the f32 side, its rounding alone puts elements past the limit, as
    it would for any bf16 kernel."""
    arrays, dout = _inputs(1, 2, 256, 64, seed=11, strong=False,
                           k_scale=1.3, w_range=(0.99, 0.996))
    arrays = [torch.from_numpy(a).bfloat16() for a in arrays]
    wide = [a.float().numpy() for a in arrays]
    dout_bf16 = torch.from_numpy(dout).bfloat16()
    got = ref.wkv_chunked_backward(*arrays, dout_bf16, split=True)
    got = [g.float().numpy() for g in got]
    want = _jax_grads(wide, dout_bf16.float().numpy())
    assert max(float(np.abs(w).max()) for w in want) > 100
    worst = _worst(got, want, BF16_GRAD_TOL)
    print("share of the card's limit taken, by gradient:", worst)
    assert max(worst.values()) <= 0.5, worst
    unrounded = _worst(got, _jax_grads(wide, dout), BF16_GRAD_TOL)
    assert max(unrounded.values()) > 1.0, unrounded


def test_chunked_backward_split_changes_little_in_f32():
    """The hi/lo split alone (f32 gradients) moves every gradient by far
    less than bf16's own rounding of it."""
    arrays, dout = _inputs(1, 2, 200, 32, seed=8, strong=True)
    ta = [torch.from_numpy(a) for a in arrays]
    exact = ref.wkv_chunked_backward(*ta, torch.from_numpy(dout))
    split = ref.wkv_chunked_backward(*ta, torch.from_numpy(dout),
                                     split=True)
    for a, b in zip(split, exact):
        assert float((a - b).abs().max()) <= 2 ** -12 * (
            1 + float(b.abs().max()))


def test_chunked_backward_other_chunking():
    """The decomposition does not depend on the chunk and sub-chunk
    lengths: 32 and 8 give the 64 and 16 result."""
    arrays, dout = _inputs(2, 1, 100, 16, seed=9, strong=True)
    ta = [torch.from_numpy(a) for a in arrays]
    dt = torch.from_numpy(dout)
    want = ref.wkv_chunked_backward(*ta, dt)
    got = ref.wkv_chunked_backward(*ta, dt, chunk=32, sub=8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        ref.wkv_chunked_backward(*ta, dt, chunk=40, sub=16)
