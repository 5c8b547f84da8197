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
