"""The attention and wkv kernels, forward and backward, on each rank's
local shards under ``sharding.activations.local_call`` (``local_map``):
on a (1, 1) ``("data", "model")`` mesh over NCCL at world 1, and on a
(1, 2) mesh of 2 ``gloo`` ranks sharing ``cuda:0`` (the heads split over
``model``).  Each rank holds the kernel's output and every gradient
against autograd through the plain version in float32 on the same local
shards, with ``chip_smoke.py``'s tolerances (x (1 + |want|)).

Marked ``cuda``: each test skips where no CUDA device is present.  It
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tensor_parallel_cuda.py
"""
import pytest
import torch

from repro_torch.launch.spawn import run_ranks

# forward, backward: chip_smoke.py's FLASH_TOLERANCE / GRAD_TOLERANCE and
# WKV_TOLERANCE / WKV_GRAD_TOLERANCE
TOLERANCE = {"flash_attention": {"float32": (2e-5, 1e-4),
                                 "bfloat16": (1e-2, 2e-2)},
             "wkv6": {"float32": (1e-4, 2e-3), "bfloat16": (2e-2, 2e-2)}}
B, S, D = 2, 256, 64


def _inputs(which, dtype, device):
    gen = torch.Generator(device=device).manual_seed(11)

    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    if which == "flash_attention":
        return [normal(B, 8, S, D), normal(B, 4, S, D), normal(B, 4, S, D)]
    w = (0.7 + 0.299 * torch.rand((B, 4, S, D), generator=gen,
                                  device=device)).to(dtype)
    return [normal(B, 4, S, D, scale=0.5), normal(B, 4, S, D, scale=0.5),
            normal(B, 4, S, D), w, normal(4, D, scale=0.5)]


def _max_excess(got, want, tol):
    """max of |got - want| - tol (1 + |want|): <= 0 where it holds."""
    return float(((got.detach().float() - want.detach()).abs()
                  - tol * (1 + want.abs())).max())


def _case(mesh, which, dtype):
    """The kernel on ``mesh``'s local shards against its plain version on
    the same shards: the worst excess over tolerance of the output and of
    each gradient (<= 0 passes)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    from repro_torch.sharding import activations as A
    device = mesh.device_type
    full = _inputs(which, dtype, device)
    heads = ("batch", "model", None, None)
    if which == "flash_attention":
        kernel, plain = fa_ops.attention, fa_ref.attention
        specs, partial = (heads,) * 3, ()
    else:
        kernel = wkv_ops.wkv
        plain = lambda *x: wkv_ref.wkv_chunked(*x, chunk=64)  # noqa: E731
        specs, partial = (heads,) * 4 + (("model", None),), \
            ((),) * 4 + (("data",),)
    fwd_tol, bwd_tol = TOLERANCE[which][str(dtype).split(".")[-1]]
    with A.activation_sharding(mesh, ("data",)):
        placed = [distribute_tensor(
            x, mesh, A.placements_for(
                ["data" if e == "batch" else e for e in spec], mesh),
            src_data_rank=None).requires_grad_()
            for x, spec in zip(full, specs)]
        out = A.local_call(kernel, placed, specs, heads, partial)
        dout = torch.randn(out.shape, device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(12))
        dout_d = distribute_tensor(dout.to(dtype), mesh, out.placements,
                                   src_data_rank=None)
        out.backward(dout_d)
    local = [p.detach().to_local().float().requires_grad_()
             for p in placed]
    want = plain(*local)
    want.backward(dout_d.to_local().float())
    worst = {"forward": _max_excess(out.to_local(), want, fwd_tol)}
    for i, (p, q) in enumerate(zip(placed, local)):
        grad = p.grad.redistribute(mesh, p.placements).to_local()
        worst[f"grad{i}"] = _max_excess(grad, q.grad, bwd_tol)
    return worst


CASES = [(w, d) for w in ("flash_attention", "wkv6")
         for d in (torch.bfloat16, torch.float32)]


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the NCCL mesh needs one")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    store = tmp_path_factory.mktemp("nccl_tp") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_host_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("which,dtype", CASES)
def test_kernel_on_local_shards_at_world_one(nccl_mesh, which, dtype):
    worst = _case(nccl_mesh, which, dtype)
    assert max(worst.values()) <= 0.0, worst


def _gloo_rank(rank, world):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 2), ("data", "model"), device="cuda")
    return {f"{w}/{d}": _case(mesh, w, d) for w, d in CASES}


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the gloo ranks share cuda:0")
    d = tmp_path_factory.mktemp("gloo_tp")
    return run_ranks(_gloo_rank, 2, d / "store", backend="gloo",
                     device="cuda", timeout=600)


@pytest.mark.cuda
@pytest.mark.parametrize("which,dtype", CASES)
def test_kernel_on_local_shards_over_two_gloo_ranks(gloo_ranks, which,
                                                     dtype):
    for rank in gloo_ranks:
        worst = rank[f"{which}/{dtype}"]
        assert max(worst.values()) <= 0.0, worst
