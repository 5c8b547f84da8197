"""The transformer steps on a (data 2, model 2) mesh of 4 ranks sharing
``cuda:0`` over the ``hoststage`` backend (``launch/hoststage.py``),
held to the port's own steps at ``mesh=None`` on the card: the reduced
configs of ``tests/tensor_parallel_cases.py`` (llama3.2-3b, rwkv6-1.6b,
deepseek-v2-lite-16b, jamba) through prefill, one train step and 4
decode steps at batch 16, and the pod FL step on (pod 2, data 1, model
2), each within ``TOL`` x (1 + |want|) in float32 (TF32 off).  The
params come from the port's init: the card's machine has no JAX.

Marked ``cuda``: the fixtures skip where no CUDA device is present, so
the CPU suite pays nothing.  On the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tensor_parallel_hoststage_cuda.py
"""
import pytest
import torch

import tensor_parallel_cases as C

MESH, DECODE_BATCH = (2, 2), 16


@pytest.fixture(scope="module")
def trees():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the ranks share cuda:0")
    C._tf32_off()
    return C.port_trees(fl=True)


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    from repro_torch.launch import hoststage
    hoststage.register()
    return C.spawn(MESH, trees, tmp_path_factory, DECODE_BATCH, fl=True,
                   backend=hoststage.BACKEND, device="cuda")


@pytest.fixture(scope="module")
def want(trees):
    return C.one_device(trees, DECODE_BATCH, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", C.NAMES)
def test_hoststage_steps_match_one_device_steps(ranks, want, name):
    C.check_against(ranks, want, name)


@pytest.mark.cuda
def test_hoststage_pod_fl_step_matches_one_device_step(ranks, trees):
    want0, want_metrics = C.one_device_fl(trees, device="cuda")
    for r, rank in enumerate(ranks):
        got, metrics = rank["fl"]
        C._trees_close(got, want0, f"rank {r}")
        for key in ("loss", "ce", "aux"):
            assert abs(metrics[key] - want_metrics[key]) <= C.TOL * (
                1 + abs(want_metrics[key])), key
