"""Tensor and FSDP parallelism on a (data 4, model 2) mesh of 8 ``gloo``
ranks, held to the reference's unsharded steps (cases and tolerance:
``tests/tensor_parallel_cases.py``).  Decode at batch 8: the caches split
their sequence over ``("data", "model")``."""
import pytest

import tensor_parallel_cases as C

MESH, DECODE_BATCH = (4, 2), 8


@pytest.fixture(scope="module")
def trees():
    return C.make_trees(fl=False)


@pytest.fixture(scope="module")
def ranks(trees, tmp_path_factory):
    return C.spawn(MESH, trees, tmp_path_factory, DECODE_BATCH, fl=False)


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
