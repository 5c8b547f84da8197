"""The eq.-(13) aggregate across ranks, on several ``gloo`` ranks on the
CPU: ``hierarchical_weighted_psum``, ``make_replica_agg_step``,
``shard_weighted_aggregate`` and the pod form of ``make_fl_train_step``.

One spawn of 8 ranks (``repro_torch.launch.spawn.run_ranks``, a
``file://`` store under ``tmp_path``) runs every case:
  * the all-reduce on a (pod 2, data 4) mesh, against the reference's
    ``make_replica_agg_step`` on 8 forced host devices (its own test,
    ``tests/test_mesh_fl.py::test_hierarchical_psum_matches_mean``,
    passes under jax 0.9) run in a subprocess on the same NumPy values,
    a weight of its own on each shard: within 1e-6 (the same float32
    products, summed in another order);
  * ``shard_weighted_aggregate`` (one bucket) and its multi-bucket form
    on a 4-rank ``data`` mesh, each rank 2 clients of a bucket, against
    the reference's ``fedavg_stacked`` / ``fedavg_stacked_multi`` on the
    unsharded stacks: within 1e-6;
  * ``make_fl_train_step(mesh)`` with a 2-rank ``pod`` mesh, one replica
    a rank (reduced llama3.2-3b, float32, ``h_local`` 2), against the
    port's one-device step over both replicas, which
    ``tests/test_torch_train.py`` holds to the reference (the
    reference's own mesh step is red under jax 0.9): params within
    1e-5 x (1 + |p|), the replicas equal across ranks, metrics within
    1e-5 relative.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.spawn import run_ranks

ROOT = Path(__file__).resolve().parents[1]
STEP_TOL = 1e-5
LR, SEQ, BATCH = 0.1, 64, 2


def _psum_inputs():
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(2, 4, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(2, 4, 7)).astype(np.float32),
            "s": rng.normal(size=(2, 4)).astype(np.float32)}
    lam = rng.uniform(0.5, 1.5, size=(2, 4))
    return tree, (lam / lam.sum()).astype(np.float32)


def _stack_inputs():
    """Two size buckets of 8 and 4 clients of a 3-leaf model, and the
    globally normalized weights over the 12 (padding ones 0)."""
    rng = np.random.default_rng(1)
    shapes = {"w": (6, 5), "b": (5,), "c": (3, 2, 2)}
    parts = [{k: rng.normal(size=(c,) + s).astype(np.float32)
              for k, s in shapes.items()} for c in (8, 4)]
    w = rng.uniform(1, 10, size=12)
    w[[7, 10, 11]] = 0.0
    return parts, (w / w.sum()).astype(np.float32)


def _llama():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-3b").reduced(),
                               param_dtype="float32")


def _fl_inputs(cfg):
    from repro_torch.models import transformer as T
    rng = np.random.default_rng(7)
    shape = (2, BATCH, SEQ)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shape)
                                 .astype(np.int32))
             for k in ("inputs", "labels")}
    reps = [T.init_params(cfg, seed=s, device="cpu") for s in (5, 6)]
    return reps, batch


def _tree_numpy(tree):
    from repro_torch.tree import tree_leaves
    return [x.detach().numpy().copy() for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# the ranks' side: imports only the port
# ---------------------------------------------------------------------------
def _ranks_main(rank, world):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.configs.shapes import InputShape
    from repro_torch.fl.aggregation import (hierarchical_weighted_psum,
                                            shard_weighted_aggregate,
                                            shard_weighted_aggregate_multi)
    from repro_torch.launch.mesh import make_cohort_mesh
    from repro_torch.launch.train import (make_fl_train_step,
                                          make_replica_agg_step)
    from repro_torch.tree import tree_map
    torch.set_num_threads(1)
    out = {}
    # (pod 2, data 4): rank r holds shard (r // 4, r % 4)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    pod, data = mesh.get_coordinate()
    tree, lam = _psum_inputs()
    mine = {k: torch.from_numpy(np.array(v[pod, data])) for k, v in tree.items()}
    out["psum"] = {k: v.numpy() for k, v in hierarchical_weighted_psum(
        mine, float(lam[pod, data]), ("data", "pod"), mesh).items()}
    step = make_replica_agg_step(mesh, ("data", "pod"))
    out["agg_step"] = {k: v.numpy() for k, v in step(
        mine, torch.tensor(lam[pod, data])).items()}
    out["agg_step_pod"] = {k: v.numpy() for k, v in make_replica_agg_step(
        mesh, ("pod",))(mine, float(lam[pod, data])).items()}
    # collective constructors run on every rank; the first ranks use them
    data4 = make_cohort_mesh(4, device="cpu")
    pods2 = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("pod",))
    if rank < 4:
        parts, w = _stack_inputs()
        blocks = [{k: torch.from_numpy(v[rank * (len(v) // 4):
                                         (rank + 1) * (len(v) // 4)].copy())
                   for k, v in part.items()} for part in parts]
        w8, w4 = w[:8].reshape(4, 2), w[8:].reshape(4, 1)
        one = shard_weighted_aggregate(
            blocks[0], torch.from_numpy(w8[rank].copy()), ("data",), data4)
        multi = shard_weighted_aggregate_multi(
            blocks, torch.from_numpy(np.concatenate([w8[rank], w4[rank]])),
            ("data",), data4)
        out["shard_one"] = {k: v.numpy() for k, v in one.items()}
        out["shard_multi"] = {k: v.numpy() for k, v in multi.items()}
    if rank < 2:
        cfg = _llama()
        reps, batch = _fl_inputs(cfg)
        mine = tree_map(lambda x: x[None].clone(), reps[rank])
        shape = InputShape("fl_cpu", SEQ, 2 * BATCH, "train")
        fl = make_fl_train_step(cfg, 2, shape, lr=LR, h_local=2,
                                device="cpu", mesh=pods2)
        new, metrics = fl(mine, {k: v[rank:rank + 1]
                                 for k, v in batch.items()})
        assert new is mine
        out["fl"] = (_tree_numpy(new), {k: float(v)
                                        for k, v in metrics.items()})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_fl")
    return run_ranks(_ranks_main, 8, d / "store", timeout=600)


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------
REFERENCE_PSUM = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.train import make_replica_agg_step
d = dict(np.load(sys.argv[1]))
lam = d.pop("__lam")
mesh = jax.make_mesh((2, 4), ("pod", "data"))
spec = P("pod", "data")
out = {}
for tag, axes in (("both", ("data", "pod")), ("pod", ("pod",))):
    step = make_replica_agg_step(mesh, axes, spec)
    got = step({k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(lam))
    out.update({f"{tag}/{k}": np.asarray(v) for k, v in got.items()})
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference_psum(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_fl_ref")
    tree, lam = _psum_inputs()
    np.savez(d / "in.npz", __lam=lam, **tree)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE_PSUM,
                           str(d / "in.npz"), str(d / "out.npz")],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def test_hierarchical_psum_matches_reference(ranks, reference_psum):
    """Each shard's own weight; the weighted sum on every rank."""
    tree, lam = _psum_inputs()
    w = lam.astype(np.float64).ravel()
    for rank, out in enumerate(ranks):
        pod, data = divmod(rank, 4)
        for k, v in tree.items():
            want = reference_psum[f"both/{k}"][pod, data]
            for got in (out["psum"][k], out["agg_step"][k]):
                assert got.dtype == np.float32
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
            np.testing.assert_allclose(
                out["agg_step_pod"][k],
                reference_psum[f"pod/{k}"][pod, data], atol=1e-6, rtol=0)
            # and the weighted sum itself, in float64
            exact = np.tensordot(w, v.reshape((8,) + v.shape[2:]), axes=1)
            np.testing.assert_allclose(out["psum"][k], exact, atol=1e-6,
                                       rtol=0)


def test_shard_weighted_aggregate_matches_reference(ranks):
    import jax.numpy as jnp
    from repro.fl.aggregation import fedavg_stacked, fedavg_stacked_multi
    parts, w = _stack_inputs()
    want_one = fedavg_stacked({k: jnp.asarray(v)
                               for k, v in parts[0].items()},
                              jnp.asarray(w[:8] / w[:8].sum()))
    want_multi = fedavg_stacked_multi(
        [{k: jnp.asarray(v) for k, v in part.items()} for part in parts],
        jnp.asarray(w))
    # the sharded aggregate takes the weights as given: scale bucket 0's
    # reference back to its share of the round
    scale = float(w[:8].sum())
    for out in ranks[:4]:
        for k in parts[0]:
            np.testing.assert_allclose(out["shard_one"][k],
                                       np.asarray(want_one[k]) * scale,
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(out["shard_multi"][k],
                                       np.asarray(want_multi[k]),
                                       atol=1e-6, rtol=0)
    for out in ranks[4:]:
        assert "shard_one" not in out


def test_pod_fl_train_step_matches_one_device_step(ranks):
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.tree import tree_map
    cfg = _llama()
    reps, batch = _fl_inputs(cfg)
    rep = tree_map(lambda a, b: torch.stack([a, b]), *reps)
    step = make_fl_train_step(cfg, 2, InputShape("fl_cpu", SEQ, 2 * BATCH,
                                                 "train"),
                              lr=LR, h_local=2, device="cpu")
    want, want_metrics = step(rep, batch)
    want = _tree_numpy(want)
    got = [out["fl"] for out in ranks[:2]]
    for leaves, metrics in got:
        for a, b in zip(leaves, want):
            assert a.shape[0] == 1
            err = np.abs(a[0] - b[0]) / (1 + np.abs(b[0]))
            assert err.max() <= STEP_TOL, err.max()
        for k, v in want_metrics.items():
            np.testing.assert_allclose(metrics[k], float(v), rtol=1e-5)
    # the replicas are equal across the ranks
    for a, b in zip(got[0][0], got[1][0]):
        np.testing.assert_array_equal(a, b)
    for out in ranks[2:]:
        assert "fl" not in out
