"""The mesh aggregates on the card: a world of one over NCCL, and two
``gloo`` ranks sharing ``cuda:0``.

Marked ``cuda``: each test skips where no CUDA device is present.  It
imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mesh_cuda.py

At world 1 the all-reduce is the identity, so ``hierarchical_weighted_psum``
must return ``lam * leaf`` (float32, cast back) and
``shard_weighted_aggregate`` the plain ``ref.aggregate`` of its stacks,
through one ``fedavg_agg`` launch, within the kernel's float32 tolerance
(1e-6, ``chip_smoke.py``'s ``TOLERANCE``).  On two ranks the client-
sharded cohort engine must match the single-device engine on the card
within the reference's tolerance (rtol 1e-5, atol 1e-6).
"""
import numpy as np
import pytest
import torch

from repro_torch.fl import aggregation as agg
from repro_torch.kernels.fedavg_agg import kernel as agg_kernel
from repro_torch.kernels.fedavg_agg import ref as agg_ref
from repro_torch.launch.mesh import make_cohort_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.launch.train import make_replica_agg_step
from repro_torch.models import cnn
from repro_torch.tree import tree_leaves, tree_map

TOL = 1e-6


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the NCCL mesh needs one")
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield make_cohort_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def _mnist(device, clients=0, seed=0):
    params, _ = cnn.build_model("mnist", seed, torch.device(device),
                                image_shape=(28, 28, 1))
    if not clients:
        return params
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return tree_map(lambda p: torch.randn((clients,) + tuple(p.shape),
                                          generator=gen).to(device), params)


@pytest.mark.cuda
def test_psum_at_world_one_is_lam_times_params(nccl_mesh):
    params = _mnist("cuda")
    for fn in (lambda t: agg.hierarchical_weighted_psum(t, 0.25, ("data",),
                                                        nccl_mesh),
               lambda t: make_replica_agg_step(nccl_mesh, ("data",))(
                   t, torch.tensor(0.25, device="cuda"))):
        out = fn(params)
        for got, p in zip(tree_leaves(out), tree_leaves(params)):
            assert got.device.type == "cuda" and got.dtype == p.dtype
            torch.testing.assert_close(got, 0.25 * p, rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_aggregate_at_world_one_launches_the_kernel(nccl_mesh, dtype):
    parts = [tree_map(lambda x: x.to(dtype), _mnist("cuda", c, seed))
             for seed, c in ((1, 32), (2, 4))]
    w = torch.rand(36, generator=torch.Generator().manual_seed(3))
    w = (w / w.sum()).to("cuda")
    before = agg_kernel.weighted_aggregate.launches
    out = agg.shard_weighted_aggregate_multi(parts, w, ("data",), nccl_mesh)
    assert agg_kernel.weighted_aggregate.launches == before + 1
    want = agg_ref.aggregate([tree_leaves(p) for p in parts], w)
    tol = TOL if dtype == torch.float32 else 2e-2
    for got, ref in zip(tree_leaves(out), want):
        assert got.dtype == dtype
        err = (got.float() - ref.float()).abs() / (1 + ref.float().abs())
        assert float(err.max()) <= tol


def _mlp_apply(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def _two_ranks_on_one_card(rank, world):
    from repro_torch.fl.cohort_engine import CohortEngine
    rng = np.random.default_rng(0)
    x = rng.normal(size=(900, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=900)
    pools = [np.arange(k * 30, (k + 1) * 30) for k in range(8)]
    pools.append(np.arange(240, 900))
    gen = torch.Generator().manual_seed(0)
    init = {"w1": torch.randn(32, 16, generator=gen) * 0.1,
            "b1": torch.zeros(16), "b2": torch.zeros(10),
            "w2": torch.randn(16, 10, generator=gen) * 0.1}
    out = {}
    for mode in ("mesh", "off"):
        eng = CohortEngine(_mlp_apply, batch_align=8, client_align=4,
                           device="cuda", sharding=mode, guard=True)
        params = {k: v.cuda() for k, v in init.items()}
        rounds = []
        for r in range(3):
            c = eng.build(x, y, pools, 3, np.random.default_rng(10 + r),
                          max_batch=16)
            params, losses = eng.round(params, c, 0.1, 900)
            rounds.append(({k: v.cpu().numpy() for k, v in params.items()},
                           losses))
        out[mode] = (eng.shards, rounds)
    return out


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    ranks = run_ranks(_two_ranks_on_one_card, 2, tmp_path / "store",
                      device="cuda", timeout=600)
    for out in ranks:
        assert out["mesh"][0] == 2 and out["off"][0] == 1
        for (p, losses), (p_off, l_off) in zip(out["mesh"][1],
                                               out["off"][1]):
            np.testing.assert_allclose(losses, l_off, rtol=1e-5, atol=1e-6)
            for k in p_off:
                np.testing.assert_allclose(p[k], p_off[k], rtol=1e-5,
                                           atol=1e-6)
