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

# the reference's sweep (tests/test_kernels.py), the MNIST CNN's largest
# leaf at the paper setup's 68 clients, and a ragged width
SHAPES = [(1, 7), (3, 100), (5, 128, 33), (2, 16384), (4, 3, 5, 7),
          (68, 3136, 128), (3, 1001)]
DTYPES = [("float32", 1e-6), ("bfloat16", 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fedavg_agg kernel has no "
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
