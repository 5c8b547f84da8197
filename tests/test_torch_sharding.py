"""The port's partition-spec tables against the reference's.

``repro_torch.sharding.specs`` walks the port's trees by key path as the
reference walks its pytrees.  Both sides count shapes only: the
reference's ``abstract_params`` / ``abstract_cache`` under
``jax.eval_shape``, the port's on the ``meta`` device, at full size for
all ten configs.  The port keeps a list of per-block dicts where the
reference stacks the blocks over a leading layer axis: a block leaf's
spec (params and cache) is the reference's without its leading ``None``,
at the same leaf of the same shape less that axis.  Also the reference's
own checks (``tests/test_sharding.py``): the specs cover every leaf, put
over 95 % of the weight bytes on a mesh axis, and divide the (16, 16)
production mesh.  No process group is needed.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES as JSHAPES
from repro.configs import get_config as jax_get_config
from repro.launch.serve import abstract_cache as jax_abstract_cache
from repro.launch.train import abstract_params as jax_abstract_params
from repro.sharding import specs as JS
from repro_torch.configs import SHAPES, get_config, supports
from repro_torch.launch.serve import abstract_cache
from repro_torch.launch.train import abstract_params
from repro_torch.sharding import specs as S
from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.tree import tree_map_with_path

AXIS_SIZE = {"data": 16, "model": 16, "pod": 2}


def _jax_by_path(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            leaf for p, leaf in flat}


def _by_path(tree):
    out = {}
    tree_map_with_path(out.__setitem__, tree)
    return out


def _jax_specs(tree):
    return _jax_by_path(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _param_path(path):
    """The reference's path of a port param leaf, and whether the
    reference stacks it: a block leaf loses its block index."""
    if path[0] == "blocks":
        return (path[0],) + path[2:], True
    return path, False


def _cache_path(path):
    """The same for a cache leaf: the port's cache is the list of
    blocks."""
    return path[1:], True


def _assert_specs_match(port_specs, port_shapes, ref_specs, ref_shapes,
                        ref_path):
    """Leaf by leaf; ``ref_path(path)`` gives the reference's path of a
    port leaf and whether its leaf carries the layer axis the port's
    lacks."""
    ports = _by_path(port_specs)
    shapes = _by_path(port_shapes)
    refs, ref_shape = _jax_specs(ref_specs), _jax_by_path(ref_shapes)
    assert len(ports) == len(shapes)
    seen = set()
    for path, spec in ports.items():
        rp, stacked = ref_path(path)
        seen.add(rp)
        want, want_shape = tuple(refs[rp]), tuple(ref_shape[rp].shape)
        assert isinstance(spec, P)
        if stacked:
            want_shape = want_shape[1:]
            if want:
                assert want[0] is None, (rp, want)
                want = want[1:]
        assert tuple(shapes[path].shape) == want_shape, path
        assert tuple(spec) == want, (path, tuple(spec), want)
    assert seen == set(refs)


@pytest.mark.parametrize("fsdp,pod", [(True, False), (False, False),
                                      (True, True)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, fsdp, pod):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jshapes, shapes = jax_abstract_params(jcfg), abstract_params(cfg)
    _assert_specs_match(
        S.param_pspecs(cfg, shapes, fsdp=fsdp, pod_shard_params=pod), shapes,
        JS.param_pspecs(jcfg, jshapes, fsdp=fsdp, pod_shard_params=pod),
        jshapes, _param_path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_and_cache_pspecs_match_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    n = 0
    for name, shape in SHAPES.items():
        if not supports(cfg, shape):
            continue
        jshape = JSHAPES[name]
        for multi_pod in (False, True):
            assert S.batch_axes(multi_pod) == JS.batch_axes(multi_pod)
            assert tuple(S.data_pspec(cfg, shape, multi_pod)) == tuple(
                JS.data_pspec(jcfg, jshape, multi_pod))
            if shape.kind != "decode":
                continue
            n += 1
            cache = abstract_cache(cfg, shape)
            jcache = jax_abstract_cache(jcfg, jshape)
            _assert_specs_match(
                S.cache_pspecs(cfg, cache, shape, multi_pod), cache,
                JS.cache_pspecs(jcfg, jcache, jshape, multi_pod), jcache,
                _cache_path)
    assert n >= 2   # decode_32k, and long_500k where it is supported
    with pytest.raises(ValueError):
        S.data_pspec(cfg, SHAPES["decode_32k"], False, which="labels")


def test_cohort_step_specs_and_data_axis_size():
    (ins, outs) = S.cohort_step_specs()
    (jins, jouts) = JS.cohort_step_specs()
    assert [tuple(s) for s in ins] == [tuple(s) for s in jins]
    assert [tuple(s) for s in outs] == [tuple(s) for s in jouts]
    assert S.data_axis_size(None) == JS.data_axis_size(None) == 1


def test_data_axis_size_reads_a_device_mesh():
    """A 1-D ``data`` mesh and a (pod, data) one on a fake process group
    of 8 (no processes, no communication)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    try:
        assert S.data_axis_size(init_device_mesh(
            "cpu", (8,), mesh_dim_names=("data",))) == 8
        assert S.data_axis_size(init_device_mesh(
            "cpu", (2, 4), mesh_dim_names=("pod", "data"))) == 4
        assert S.data_axis_size(init_device_mesh(
            "cpu", (8,), mesh_dim_names=("pod",))) == 1
    finally:
        dist.destroy_process_group()


def test_partition_spec_is_an_immutable_leaf():
    spec = P("data", None, ("pod", "data"), ("model",))
    assert tuple(spec) == ("data", None, ("pod", "data"), "model")
    assert spec == P("data", None, ("pod", "data"), "model")
    assert hash(spec) == hash(P("data", None, ("pod", "data"), "model"))
    assert tuple(P()) == ()
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec(
        "data", None, ("pod", "data"), ("model",)))
    with pytest.raises(AttributeError):
        spec._entries = ()
    with pytest.raises(TypeError):
        P(3)
    # a tree helper takes it for a leaf
    assert _by_path({"a": [spec]}) == {("a", "0"): spec}


def _sharded_dims(spec, shape):
    for dim, ax in zip(shape, tuple(spec)):
        if ax is not None:
            axes = ax if isinstance(ax, tuple) else (ax,)
            yield dim, int(np.prod([AXIS_SIZE[a] for a in axes]))


@pytest.mark.parametrize("arch", ["qwen3-32b", "qwen3-moe-235b-a22b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "deepseek-v2-lite-16b"])
def test_param_specs_cover_all_leaves(arch):
    cfg = get_config(arch)
    shapes = abstract_params(cfg)
    specs, leaves = _by_path(S.param_pspecs(cfg, shapes)), _by_path(shapes)
    assert specs.keys() == leaves.keys()
    sharded = total = 0
    for path, leaf in leaves.items():
        b = leaf.numel() * leaf.element_size()
        total += b
        if any(ax is not None for ax in specs[path]):
            sharded += b
    assert sharded / total > 0.95


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_param_specs_divisible_on_production_mesh(arch):
    cfg = get_config(arch)
    shapes = abstract_params(cfg)
    specs, leaves = _by_path(S.param_pspecs(cfg, shapes)), _by_path(shapes)
    for path, leaf in leaves.items():
        for dim, n in _sharded_dims(specs[path], leaf.shape):
            assert dim % n == 0, (arch, path, tuple(leaf.shape))


@pytest.mark.parametrize("arch,shape_name", [
    ("qwen3-32b", "decode_32k"), ("rwkv6-1.6b", "long_500k"),
    ("deepseek-v2-lite-16b", "long_500k"),
    ("jamba-1.5-large-398b", "decode_32k")])
def test_cache_specs_divisible(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    cache = abstract_cache(cfg, shape)
    specs = _by_path(S.cache_pspecs(cfg, cache, shape, multi_pod=False))
    for path, leaf in _by_path(cache).items():
        assert leaf.device == torch.device("meta")
        for dim, n in _sharded_dims(specs[path], leaf.shape):
            assert dim % n == 0, (arch, shape_name, path, tuple(leaf.shape))
