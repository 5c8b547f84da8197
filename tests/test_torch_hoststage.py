"""The ``hoststage`` backend (``repro_torch.launch.hoststage``) against
plain ``gloo``, on CPU tensors: 2 spawned ranks whose default group is
``hoststage`` also make a plain ``gloo`` group of the same ranks, run
every collective the port's mesh steps dispatch over both, through
``torch.distributed._functional_collectives`` and through DTensor's
``redistribute``, and hand back both results.  Each must be bit for bit
plain ``gloo``'s (``ReduceOp.AVG``, which ``gloo`` lacks: its sum over
the world size).  The backend's counts and bytes, its registration for
both devices, and a collective it does not serve raising are held
too."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import hoststage
from repro_torch.launch.spawn import run_ranks

WORLD = 2
FUNCTIONAL = ("all_gather_into_tensor", "reduce_scatter_sum",
              "reduce_scatter_avg", "all_reduce_sum", "all_reduce_avg",
              "broadcast", "all_to_all_single")
# (from, to) placements on a 1-D mesh of the 2 ranks
REDISTRIBUTE = (("shard0", "replicate"), ("shard1", "replicate"),
                ("partial", "replicate"), ("partial", "shard0"),
                ("replicate", "shard1"))


def _functional(which, x, group):
    """``which`` on ``x`` over ``group`` as DTensor dispatches it; an
    average over plain ``gloo`` is its sum over the world size."""
    import torch.distributed._functional_collectives as fc
    plain = dist.get_backend(group) == "gloo"
    if which == "all_gather_into_tensor":
        y = fc.all_gather_tensor(x, 0, group)
    elif which.startswith(("reduce_scatter", "all_reduce")):
        op = which.split("_")[-1]
        call = (fc.reduce_scatter_tensor if which.startswith("reduce")
                else fc.all_reduce)
        args = (x, "sum" if plain else op) + (
            (0, group) if which.startswith("reduce") else (group,))
        y = fc.wait_tensor(call(*args))
        if plain and op == "avg":
            y = y / WORLD
    elif which == "broadcast":
        y = fc.broadcast(x, 1, group)
    else:
        y = fc.all_to_all_single(x, [2, 2], [2, 2], group)
    return fc.wait_tensor(y).numpy().copy()


def _placement(name):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"shard0": Shard(0), "shard1": Shard(1), "partial": Partial(),
            "replicate": Replicate()}[name]


def _redistribute(src, dst, x, mesh):
    """``x`` (this rank's local value) as a DTensor placed ``src``,
    brought to ``dst``: this rank's local result."""
    from torch.distributed.tensor import DTensor
    d = DTensor.from_local(x, mesh, [_placement(src)], run_check=False)
    return d.redistribute(mesh, [_placement(dst)]).to_local().numpy().copy()


def _rank(rank, world):
    from torch.distributed.device_mesh import DeviceMesh
    gloo = dist.new_group(list(range(world)), backend="gloo")
    staged = dist.group.WORLD
    gen = torch.Generator().manual_seed(100 + rank)
    x = torch.randn((4, 6), generator=gen)
    out = {"backend": dist.get_backend(staged), "functional": {},
           "redistribute": {}}
    hoststage.reset_stats()
    for which in FUNCTIONAL:
        out["functional"][which] = tuple(
            _functional(which, x.clone(), g) for g in (staged, gloo))
    dist.barrier()
    out["stats"] = hoststage.stats()
    meshes = (DeviceMesh("cpu", list(range(world))),
              DeviceMesh.from_group(gloo, "cpu"))
    for src, dst in REDISTRIBUTE:
        out["redistribute"][f"{src}->{dst}"] = tuple(
            _redistribute(src, dst, x.clone(), m) for m in meshes)
    try:
        dist.gather(x, [torch.empty_like(x)] * world if rank == 0 else None)
        out["gather"] = "ran"
    except RuntimeError as exc:
        out["gather"] = str(exc)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("hoststage")
    return run_ranks(_rank, WORLD, d / "store", backend=hoststage.BACKEND,
                     timeout=120)


@pytest.mark.parametrize("which", FUNCTIONAL)
def test_functional_collective_is_gloos_bit_for_bit(ranks, which):
    for rank in ranks:
        staged, plain = rank["functional"][which]
        assert staged.dtype == plain.dtype and staged.shape == plain.shape
        np.testing.assert_array_equal(staged, plain)


@pytest.mark.parametrize("src,dst", REDISTRIBUTE)
def test_dtensor_redistribute_is_gloos_bit_for_bit(ranks, src, dst):
    for rank in ranks:
        staged, plain = rank["redistribute"][f"{src}->{dst}"]
        np.testing.assert_array_equal(staged, plain)


def test_default_group_is_hoststage_and_counts_what_it_ran(ranks):
    """One count a functional call (the average's sum is no second
    call), one barrier; bytes are each rank's input: 4 x 6 float32."""
    nbytes = 4 * 6 * 4
    want = {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 2,
            "all_reduce": 2, "broadcast": 1, "all_to_all_single": 1,
            "barrier": 1}
    for rank in ranks:
        assert rank["backend"] == hoststage.BACKEND
        got = rank["stats"]
        assert {k: v["count"] for k, v in got.items()} == want
        for k, v in got.items():
            assert v["bytes"] == (0 if k == "barrier" else nbytes * want[k])


def test_a_collective_it_does_not_serve_raises(ranks):
    for rank in ranks:
        assert rank["gather"] != "ran"


def test_registered_for_both_devices_once():
    hoststage.register()
    hoststage.register()
    assert set(dist.Backend.backend_capability[hoststage.BACKEND]) == {
        "cpu", "cuda"}
