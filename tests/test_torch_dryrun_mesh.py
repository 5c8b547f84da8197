"""The dry run on the production meshes: ``launch/dryrun.py`` with
``--mesh single`` ((16, 16) ``("data", "model")``) and ``--mesh multi``
((2, 16, 16) with ``pod``), each on a ``"fake"`` process group of 256 or
512 ranks started in a subprocess of its own (this process keeps no
group).  Every count is rank 0's, per device, on its local shards
(``launch/op_analysis.py`` counts a DTensor op where DTensor runs it).

  * A config whose 16 heads split over ``model`` (olmo-1b's heads on a
    reduced width): per-device FLOPs x 256 over the one-device count of
    the same step is in [0.99, 2.0] (no work lost, little repeated), the
    per-device count is below the one-device one, and the collectives
    are there by kind: FSDP's all-gathers and reduce-scatters, tensor
    parallelism's all-reduces; the FL step on ``multi`` adds the pod
    all-reduce of the float32 params.
  * All ten configs at reduced size (4 heads: gathered over a ``model``
    axis of 16) end ``ok`` at ``single`` for prefill, train and decode,
    and record their layouts.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCH_IDS

ROOT = Path(__file__).resolve().parents[1]

SIXTEEN_HEADS = """
import dataclasses, json, sys
from repro_torch.configs import get_config, InputShape
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("olmo-1b").reduced(), n_heads=16,
                          n_kv_heads=16, d_head=16)
shape = InputShape("x", 128, 32, "train")
out = {"one": dryrun.run_one(cfg, shape, "one"),
       "single": dryrun.run_one(cfg, shape, "single"),
       "multi_fl": dryrun.run_one(cfg, shape, "multi", fl_step=True),
       "one_fl": dryrun.run_one(cfg, shape, "one", fl_step=True)}
print("RESULT" + json.dumps(out))
"""

EVERY_CONFIG = """
import json
from repro_torch.configs import ARCH_IDS, get_config, InputShape
from repro_torch.launch import dryrun
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch).reduced()
    for kind, batch in (("prefill", 16), ("train", 16), ("decode", 16)):
        rec = dryrun.run_one(cfg, InputShape("x", 64, batch, kind),
                             "single")
        out[f"{arch}/{kind}"] = {k: rec.get(k) for k in (
            "status", "n_chips", "flops_per_dev", "layouts",
            "collective_bytes_per_dev")}
print("RESULT" + json.dumps(out))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def sixteen_heads():
    return _run(SIXTEEN_HEADS)


@pytest.fixture(scope="module")
def every_config():
    return _run(EVERY_CONFIG)


def test_single_mesh_counts_local_shards(sixteen_heads):
    one, single = sixteen_heads["one"], sixteen_heads["single"]
    assert single["status"] == "ok" and single["n_chips"] == 256
    assert single["flops_per_dev"] < one["flops_per_dev"]
    ratio = single["flops_per_dev"] * 256 / one["flops_per_dev"]
    assert 0.99 <= ratio <= 2.0, ratio
    assert single["layouts"] == {"attention:split": {
        "n_q": 16, "n_kv": 16, "model": 16, "layout": "split"}}
    assert single["roofline"]["op_flops_total"] == pytest.approx(
        single["flops_per_dev"] * 256)


def test_single_mesh_collectives_by_kind(sixteen_heads):
    single = sixteen_heads["single"]
    coll = single["collective_bytes_per_dev"]
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert coll.get(kind, 0) > 0, (kind, coll)
    assert coll["total"] == pytest.approx(sum(
        v for k, v in coll.items() if k != "total"))
    assert single["roofline"]["t_collective_s"] > 0
    assert sixteen_heads["one"]["collective_bytes_per_dev"] == {"total": 0}


def test_multi_mesh_fl_step(sixteen_heads):
    """One replica a pod, sharded over (16, 16) inside it: the FL step's
    per-device FLOPs x 512 against the one-device FL step over both
    replicas, and the pod all-reduce of the local float32 params."""
    fl, one = sixteen_heads["multi_fl"], sixteen_heads["one_fl"]
    assert fl["status"] == "ok" and fl["n_chips"] == 512 and fl["fl_step"]
    ratio = fl["flops_per_dev"] * 512 / one["flops_per_dev"]
    assert 0.99 <= ratio <= 2.0, ratio
    coll = fl["collective_bytes_per_dev"]
    local_f32 = fl["memory"]["param_bytes"]      # f32 params, one replica
    assert coll["all-reduce"] >= local_f32
    assert coll["all-gather"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_ends_ok_at_single(every_config, arch):
    for kind in ("prefill", "train", "decode"):
        rec = every_config[f"{arch}/{kind}"]
        assert rec["status"] == "ok", (arch, kind)
        assert rec["n_chips"] == 256 and rec["flops_per_dev"] > 0
        if kind != "decode":
            assert rec["collective_bytes_per_dev"]["total"] > 0
    layouts = every_config[f"{arch}/prefill"]["layouts"]
    # the reduced configs' 4 heads (2 kv for internvl2) cannot split
    # over 16: attention, MLA and the wkv heads are gathered
    assert all(v["layout"] in ("gathered", "experts_gathered")
               for v in layouts.values()), layouts
