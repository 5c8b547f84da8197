"""Wrapper of the Hopper ``fedavg_agg`` kernel (``csrc/fedavg_agg.cu``).

The counterpart of the reference's Pallas kernel
(``repro/kernels/fedavg_agg/kernel.py``): ``out[p] = sum_c w[c] x[c, p]``
over the leading client axis, f32 accumulation, output in the input's
type (f32 or bf16).  :func:`aggregate` takes every leaf of a model over
every size bucket of a cohort in one launch; :func:`weighted_aggregate`
is its one-leaf, one-bucket call.  The wrapper checks what the kernel
takes and raises on anything else, allocates the outputs, launches on
the current stream and never synchronizes.  ``weighted_aggregate.launches``
counts the launches of both.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from ..build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "fedavg_agg.cu"
MAX_CLIENTS = 12288  # the weights live in shared memory
# the launch's table of stacks, a kernel parameter: 24 bytes a leaf and
# 16 a (leaf, bucket) stack (csrc/fedavg_agg.cu, kTableBytes)
TABLE_BYTES, LEAF_BYTES, PART_BYTES = 32736, 24, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def build():
    """Compile (at first use) and bind the kernel's C entry point."""
    fn = load_library(SOURCE).fedavg_agg_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(buckets, weights, out=None) -> None:
    """What the kernel takes: the table's structure first, then the
    device."""
    if not buckets or not buckets[0]:
        raise ValueError("fedavg_agg kernel needs at least one bucket of at "
                         "least one leaf")
    first = buckets[0][0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"fedavg_agg kernel takes float32 or bfloat16, "
                        f"got {first.dtype}")
    n_leaves = len(buckets[0])
    if n_leaves * (LEAF_BYTES + len(buckets) * PART_BYTES) > TABLE_BYTES:
        raise ValueError(f"fedavg_agg kernel's table takes at most "
                         f"{TABLE_BYTES} bytes ({LEAF_BYTES} a leaf, "
                         f"{PART_BYTES} a stack), got {len(buckets)} "
                         f"buckets of {n_leaves} leaves")
    total = 0
    for b, leaves in enumerate(buckets):
        if len(leaves) != n_leaves:
            raise ValueError(f"bucket {b} has {len(leaves)} leaves, bucket "
                             f"0 has {n_leaves}")
        c = leaves[0].shape[0] if leaves[0].ndim else 0
        for l, (x, x0) in enumerate(zip(leaves, buckets[0])):
            if x.device != first.device or x.dtype != first.dtype:
                raise ValueError(f"every stack must be {first.dtype} on "
                                 f"{first.device}, got {x.dtype} on "
                                 f"{x.device} (bucket {b}, leaf {l})")
            if x.ndim < 1 or not x.is_contiguous():
                raise ValueError("fedavg_agg kernel needs contiguous "
                                 "(C, ...) tensors")
            if x.shape[0] != c or x.shape[1:] != x0.shape[1:]:
                raise ValueError(f"bucket {b} leaf {l} has shape "
                                 f"{tuple(x.shape)}: every leaf of a bucket "
                                 f"has its C clients, and every bucket the "
                                 f"leaf's shape {tuple(x0.shape[1:])}")
            if x.numel() < 1:
                raise ValueError(f"fedavg_agg kernel takes clients of at "
                                 f"least one element, got shape "
                                 f"{tuple(x.shape)}")
        total += c
    if not 1 <= total <= MAX_CLIENTS:
        raise ValueError(f"fedavg_agg kernel takes 1..{MAX_CLIENTS} clients, "
                         f"got {total}")
    if first.device.type != "cuda":
        raise ValueError(f"fedavg_agg kernel needs a CUDA tensor, got one "
                         f"on {first.device}")
    if (weights.dtype != torch.float32 or weights.shape != (total,)
            or weights.device != first.device
            or not weights.is_contiguous()):
        raise ValueError(f"weights must be a contiguous float32 ({total},) "
                         f"tensor on {first.device}, got "
                         f"{weights.dtype} {tuple(weights.shape)} on "
                         f"{weights.device}")
    if out is None:
        return
    if len(out) != n_leaves:
        raise ValueError(f"out holds {len(out)} tensors for {n_leaves} "
                         f"leaves")
    for l, (o, x) in enumerate(zip(out, buckets[0])):
        if (o.shape != x.shape[1:] or o.dtype != first.dtype
                or o.device != first.device or not o.is_contiguous()):
            raise ValueError(f"out[{l}] must be a contiguous {first.dtype} "
                             f"{tuple(x.shape[1:])} tensor on "
                             f"{first.device}, got {o.dtype} "
                             f"{tuple(o.shape)} on {o.device}")


def aggregate(buckets: Sequence[Sequence[torch.Tensor]],
              weights: torch.Tensor,
              out: Optional[Sequence[torch.Tensor]] = None
              ) -> List[torch.Tensor]:
    """Every leaf over every bucket, in one launch.

    ``buckets[b][l]`` is leaf ``l``'s (C_b, ...) stack in bucket ``b``, all
    of one type on one CUDA device; ``weights`` is the (sum C_b,) float32
    vector in bucket order.  Returns leaf ``l``'s weighted sum over all
    clients, for every ``l``: written into ``out[l]`` when ``out`` is
    given (each contiguous, of the leaf's shape and type; views of one
    flat buffer, say), else into new tensors.
    """
    _check(buckets, weights, out)
    first = buckets[0][0]
    outs = (list(out) if out is not None else
            [torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
             for x in buckets[0]])
    xs = [x.data_ptr() for leaves in buckets for x in leaves]
    clients = [leaves[0].shape[0] for leaves in buckets]
    sizes = [x[0].numel() for x in buckets[0]]
    out_ptrs = [o.data_ptr() for o in outs]
    launch = build()
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(len(buckets), len(outs),
                    (ctypes.c_void_p * len(xs))(*xs),
                    (ctypes.c_int * len(clients))(*clients),
                    (ctypes.c_void_p * len(outs))(*out_ptrs),
                    (ctypes.c_int64 * len(sizes))(*sizes),
                    weights.data_ptr(), _DTYPES[first.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_agg launch failed: CUDA error {rc} "
                           f"({len(buckets)} buckets of {len(outs)} leaves, "
                           f"{first.dtype})")
    weighted_aggregate.launches += 1
    return outs


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor
                       ) -> torch.Tensor:
    """stacked (C, ...) on a CUDA device -> (...,) weighted sum over C."""
    return aggregate([[stacked]], weights)[0]


weighted_aggregate.launches = 0
