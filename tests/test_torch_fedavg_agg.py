"""Parity of the port's fedavg_agg op with the reference's Pallas kernel.

The same numpy inputs go through the reference kernel in interpret mode,
the reference's jnp oracle, and the port's plain version and dispatcher
on the CPU, over the reference's own sweep (shapes and tolerances of
``tests/test_kernels.py``).  The CUDA kernel itself runs only on a card:
its tests are in ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedavg_agg import kernel as jax_kernel, ref as jax_ref
from repro_torch.kernels.fedavg_agg import kernel, ops, ref

SHAPES = [(1, 7), (3, 100), (5, 128, 33), (2, 16384), (4, 3, 5, 7)]
DTYPES = [("float32", 1e-6), ("bfloat16", 2e-2)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=shape[0]).astype(np.float32)
    return x, (w / w.sum()).astype(np.float32)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_port_matches_reference_kernel(shape, dtype, tol):
    x, w = _inputs(shape)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_kernel = np.asarray(jax_kernel.weighted_aggregate(
        jx, jnp.asarray(w), interpret=True), np.float32)
    want_ref = np.asarray(jax_ref.weighted_aggregate(jx, jnp.asarray(w)),
                          np.float32)
    tx, tw = _torch(x, dtype), torch.from_numpy(w)
    for got in (ref.weighted_aggregate(tx, tw),
                ops.weighted_aggregate(tx, tw)):
        assert got.dtype == tx.dtype and got.shape == tx.shape[1:]
        got = got.to(torch.float32).numpy()
        np.testing.assert_allclose(got, want_kernel, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, want_ref, rtol=tol, atol=tol)


def test_port_convex_combination_bounds():
    """Property: the aggregate lies in the convex hull of the inputs."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 257)).astype(np.float32)
    w = torch.full((4,), 0.25)
    out = ops.weighted_aggregate(torch.from_numpy(x), w).numpy()
    assert (out <= x.max(0) + 1e-5).all()
    assert (out >= x.min(0) - 1e-5).all()


def test_cpu_tensor_never_launches():
    x, w = _inputs((3, 100))
    before = kernel.weighted_aggregate.launches
    ops.weighted_aggregate(torch.from_numpy(x), torch.from_numpy(w))
    assert kernel.weighted_aggregate.launches == before


def test_kernel_wrapper_rejects_cpu_tensor():
    x, w = _inputs((3, 100))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.weighted_aggregate(torch.from_numpy(x), torch.from_numpy(w))


# ---------------------------------------------------------------------------
# the many-leaf aggregate: every leaf over every size bucket in one call
# ---------------------------------------------------------------------------
# leaf sizes from one element to the MNIST CNN's conv weights, and the
# bucket splits of the paper setup (64 + 4), of two one-client buckets and
# of a single bucket
LEAF_SIZES = [(1,), (10,), (32,), (128, 10), (64, 32, 3, 3)]
SPLITS = [(64, 4), (1, 1), (68,)]


def _buckets(split, seed=0):
    rng = np.random.default_rng(seed)
    stacks = [rng.normal(size=(sum(split),) + shape).astype(np.float32)
              for shape in LEAF_SIZES]
    w = rng.uniform(0.1, 1.0, size=sum(split)).astype(np.float32)
    bounds = np.cumsum((0,) + split)
    parts = [[x[a:b] for x in stacks] for a, b in zip(bounds, bounds[1:])]
    return stacks, parts, (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_aggregate_matches_reference_kernel(split, dtype, tol):
    """The plain many-leaf aggregate against the reference's Pallas
    kernel (interpret mode) leaf by leaf on the concatenated stacks."""
    stacks, parts, w = _buckets(split)
    tw = torch.from_numpy(w)
    got = ops.aggregate([[_torch(x, dtype) for x in leaves]
                         for leaves in parts], tw)
    assert len(got) == len(stacks)
    for x, out in zip(stacks, got):
        want = np.asarray(jax_kernel.weighted_aggregate(
            jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
            interpret=True), np.float32)
        assert out.dtype == getattr(torch, dtype)
        assert out.shape == x.shape[1:]
        np.testing.assert_allclose(out.to(torch.float32).numpy(), want,
                                   rtol=tol, atol=tol)


def test_aggregate_one_bucket_is_weighted_aggregate():
    stacks, parts, w = _buckets((68,), seed=3)
    tw = torch.from_numpy(w)
    got = ref.aggregate([[torch.from_numpy(x) for x in parts[0]]], tw)
    for x, out in zip(stacks, got):
        np.testing.assert_array_equal(
            out.numpy(),
            ref.weighted_aggregate(torch.from_numpy(x), tw).numpy())


def test_aggregate_cpu_tensors_never_launch():
    _, parts, w = _buckets((64, 4))
    before = kernel.weighted_aggregate.launches
    ops.aggregate([[torch.from_numpy(x) for x in leaves] for leaves in parts],
                  torch.from_numpy(w))
    assert kernel.weighted_aggregate.launches == before


def test_aggregate_wrapper_rejects_what_the_kernel_does_not_take():
    """A table past the kernel's 32,736 bytes of parameters (585 leaves
    over 2 buckets), mixed types, mismatched buckets and CPU tensors are
    refused before any launch; VGG-11's 18 leaves over 3 buckets and 584
    leaves over 2 fit (refused only for lying on the CPU)."""
    x = torch.zeros((2, 8))
    w = torch.full((2,), 0.5)
    with pytest.raises(ValueError, match="at most 32736 bytes"):
        kernel.aggregate([[x] * 585, [x] * 585], torch.full((4,), 0.25))
    for n_buckets, n_leaves in [(3, 18), (2, 584)]:
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernel.aggregate([[x] * n_leaves] * n_buckets,
                             torch.full((2 * n_buckets,), 0.5 / n_buckets))
    with pytest.raises(ValueError, match="every stack must be"):
        kernel.aggregate([[x, x.to(torch.bfloat16)]], w)
    with pytest.raises(TypeError):
        kernel.aggregate([[x.double()]], w)
    with pytest.raises(ValueError, match="leaves"):
        kernel.aggregate([[x, x], [x]], torch.full((4,), 0.25))
    with pytest.raises(ValueError, match="shape"):
        kernel.aggregate([[x], [torch.zeros((2, 9))]], torch.full((4,), 0.25))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.aggregate([[x, x]], w)
