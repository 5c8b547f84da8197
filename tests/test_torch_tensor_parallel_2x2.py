"""Tensor and FSDP parallelism together: the transformer steps on a
(data 2, model 2) mesh of 4 ``gloo`` ranks, held to the reference's
unsharded steps (cases and tolerance: ``tests/tensor_parallel_cases.py``).
Decode at batch 16: the batch over ``data``, the caches' sequence over
``model``.  The same 4 ranks run the pod FL step on (pod 2, data 1,
model 2) against the port's one-device FL step (which
``tests/test_torch_train.py`` holds to the reference)."""
import pytest

import tensor_parallel_cases as C

MESH, DECODE_BATCH = (2, 2), 16


@pytest.fixture(scope="module")
def trees():
    return C.make_trees(fl=True)


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    return C.spawn(MESH, trees, tmp_path_factory, DECODE_BATCH, fl=True)


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


def test_pod_fl_step_matches_one_device_step(ranks, trees):
    C.check_pod_fl_step(ranks, trees)
