"""Tensor parallelism of the transformer steps on DTensor: the train,
prefill and decode steps on a (data 1, model 2) mesh of 2 ``gloo`` ranks
on the CPU, held to the reference's unsharded steps (cases and
tolerance: ``tests/tensor_parallel_cases.py``; the FSDP, (2, 2) and
(4, 2) meshes have a file each).  Decode at batch 16.

Two llama cuts whose heads do not split over ``model`` 2 (one kv head a
rank, and gathered heads) run prefill and a train step on the same
ranks.  In this process: ``shard`` and ``local_call`` without a
context, the placements of every leaf's spec of all ten configs on a
(2, 2) mesh of a ``"fake"`` group, and the kernels' refusal of a
DTensor.
"""
import pytest
import torch

import tensor_parallel_cases as C

MESH, DECODE_BATCH = (1, 2), 16


@pytest.fixture(scope="module")
def trees():
    return C.make_trees(layouts=True)


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    return C.spawn(MESH, trees, tmp_path_factory, DECODE_BATCH,
                   layouts=C.HEAD_LAYOUTS)


@pytest.mark.parametrize("name", C.NAMES)
def test_sharded_prefill_matches_reference(ranks, trees, name):
    C.check_prefill(ranks, trees, name)


@pytest.mark.parametrize("name", C.NAMES)
def test_sharded_train_step_matches_reference(ranks, trees, name):
    C.check_train_step(ranks, trees, name)


@pytest.mark.parametrize("name", C.NAMES)
def test_sharded_decode_matches_reference(ranks, trees, name):
    C.check_decode(ranks, trees, name)


def test_layouts_are_recorded(ranks):
    C.check_layouts(ranks)


@pytest.mark.parametrize("layout", list(C.HEAD_LAYOUTS))
def test_uneven_heads_match_reference(ranks, trees, layout):
    """Heads that do not split over ``model`` 2: one kv head a rank, and
    the heads gathered; prefill logits and one train step."""
    C.check_head_layout(ranks, layout)
    C.check_prefill(ranks, trees, layout)
    C.check_train_step(ranks, trees, layout)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------
def test_shard_is_a_noop_without_a_context():
    from repro_torch.sharding import activations as A
    x = torch.randn(2, 3, 4)
    assert A.current_mesh() is None
    assert A.shard(x, "batch", None, "model") is x
    assert A.gather_fsdp({"w": x})["w"] is x


def test_local_call_is_the_call_without_a_context():
    """Without a mesh the layers' ``local_call`` sites call the kernel or
    op on the tensors themselves, and record no layout."""
    from repro_torch.sharding import activations as A
    x, y = torch.randn(2, 3), torch.randn(2, 3)
    seen = []

    def fn(*args):
        seen.append(args)
        return args[0] + args[1]

    out = A.local_call(fn, (x, y), (("batch", None), ("batch", None)),
                       ("batch", None), (("model",),))
    assert seen == [(x, y)] and torch.equal(out, x + y)
    before = A.layouts()
    A.note_layout("attention", "split", n_q=4)
    assert A.layouts() == before


@pytest.fixture
def fake_mesh():
    """A (2, 2) ``("data", "model")`` mesh on a ``"fake"`` group of 4
    ranks in this process (nothing is sent)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_mesh((2, 2), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def _expected(spec, names):
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis in names:
                out[names.index(axis)] = Shard(i)
    return out


@pytest.mark.parametrize("fsdp", [True, False])
def test_placements_of_every_config(fake_mesh, fsdp):
    """Every leaf's spec of all ten configs becomes ``Shard(i)`` on the
    mesh dims entry ``i`` names and ``Replicate()`` on the others; a
    placed leaf keeps the global shape and holds its chunk."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.train import abstract_params
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.specs import (distribute_params, param_pspecs,
                                            placements)
    from repro_torch.tree import tree_leaves
    names = ("data", "model")
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        shapes = abstract_params(cfg)
        specs = param_pspecs(cfg, shapes, fsdp=fsdp)
        for spec in tree_leaves(specs):
            assert placements(spec, fake_mesh) == _expected(spec, names)
        placed = distribute_params(shapes, fake_mesh, specs)
        for leaf, spec, shape in zip(tree_leaves(placed),
                                     tree_leaves(specs),
                                     tree_leaves(shapes)):
            assert leaf.shape == shape.shape
            local = list(shape.shape)
            for p in leaf.placements:
                if isinstance(p, Shard):
                    local[p.dim] = -(-local[p.dim] // 2)
            assert list(leaf.to_local().shape) == local, (arch, spec)
    # fixed points: the embedding (vocab over model, d_model over data),
    # a replicated norm, and a pod axis the mesh lacks
    assert placements(P("model", "data"), fake_mesh) == [Shard(1), Shard(0)]
    assert placements(P(None), fake_mesh) == [Replicate(), Replicate()]
    assert placements(P(("pod", "data")), fake_mesh) == [Shard(0),
                                                         Replicate()]


def test_placing_copies_the_callers_tensors(fake_mesh):
    """A placed leaf holds a copy of its chunk: a donated step writing
    into it leaves the caller's full tensor as it was."""
    from repro_torch.sharding.specs import PartitionSpec as P
    from repro_torch.sharding.specs import distribute_params
    full = torch.arange(8.0).reshape(4, 2)
    placed = distribute_params({"w": full}, fake_mesh,
                               {"w": P("data", None)})["w"]
    placed.to_local().fill_(-1.0)
    assert torch.equal(full, torch.arange(8.0).reshape(4, 2))


def test_kernels_refuse_a_dtensor(fake_mesh):
    """A DTensor never reaches a kernel's dispatcher: under a mesh the
    layers hand over local shards (``activations.local_call``)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.kernels.fedavg_agg import ops as agg_ops
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.wkv6 import ops as wkv
    rep = [Replicate(), Replicate()]
    q = distribute_tensor(torch.randn(1, 2, 8, 4), fake_mesh, rep)
    u = distribute_tensor(torch.randn(2, 4), fake_mesh, rep)
    with pytest.raises(TypeError, match="local shards"):
        fa.attention(q, q, q)
    with pytest.raises(TypeError, match="local shards"):
        wkv.wkv(q, q, q, q, u)
    with pytest.raises(TypeError, match="local shards"):
        agg_ops.weighted_aggregate(q, u[0])
