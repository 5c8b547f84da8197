"""Device meshes over ``torch.distributed``, and the card's constants for
the roofline model (``launch/dryrun.py``).

The counterpart of the reference's ``launch/mesh.py``.  One process is
one device of the reference's mesh: ``jax.make_mesh`` becomes a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default
process group, with the reference's axis names, and a ``psum`` over an
axis is an all-reduce over ``mesh.get_group(axis)``.  Nothing here
starts a process group: a launcher (``torchrun``, a test, or
``chip_smoke.py`` through :mod:`.spawn`) calls ``init_process_group``
and ``torch.cuda.set_device(local_rank)`` first, and a mesh asked for
without a group raises.  A world of one process needs no group and no
mesh (``mesh=None`` is the one-device path).  The mesh's device type is
the caller's device, never guessed.  ``make_production_mesh`` gives the
reference's (16, 16) and (2, 16, 16) meshes over a default group of 256
or 512 ranks: real ones, or a ``"fake"`` group for the dry run on
``meta`` (``launch/dryrun.py``); ``make_mesh`` any small one.

The constants are one NVIDIA H100 80GB HBM3 (SXM, 700 W)'s, from
NVIDIA's H100 Tensor Core GPU data sheet (dense rates, without
sparsity), where the reference's are a TPU v5e's.  ``chip_smoke.py``
takes its bounds from them too.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_mesh", "make_cohort_mesh",
           "make_host_mesh", "group_rank",
           "group_size", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "HBM_BW",
           "NVLINK_BW", "peak_flops"]

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12          # FLOP/s, f32 on the CUDA cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW = 900e9               # bytes/s, NVLink 4, all links of one card


def peak_flops(dtype) -> float:
    """The peak rate for operands of ``dtype`` (a torch dtype or its
    name): bf16 (and f16) on the tensor cores, anything else at the f32
    rate."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return (PEAK_FLOPS_BF16 if dtype in (torch.bfloat16, torch.float16)
            else PEAK_FLOPS_F32)


def group_size() -> int:
    """Ranks in the default process group; 1 when none is up."""
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def group_rank() -> int:
    """This process's rank in the default process group; 0 when none is
    up."""
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import DeviceMesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {names} mesh needs torch.distributed's default process "
            f"group: call init_process_group first (one process needs no "
            f"mesh: pass mesh=None)")
    n = 1
    for d in shape:
        n *= d
    ranks = torch.arange(n, dtype=torch.int).reshape(shape)
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, device="cuda"):
    """The reference's production mesh over the default process group:
    (16, 16) with axes ``("data", "model")``, or with ``multi_pod``
    (2, 16, 16) with ``("pod", "data", "model")``.  The group must hold
    exactly 256 or 512 ranks, real or ``"fake"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 512 if multi_pod else 256
    if group_size() != need:
        raise RuntimeError(
            f"the {'multi' if multi_pod else 'single'}-pod production mesh "
            f"{shape} needs a default process group of {need} ranks, got "
            f"{group_size()} (a 'fake' group serves the dry run)")
    return _mesh(shape, names, device)


def make_mesh(shape, names, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the first
    ranks of the default process group (the tests' and the smoke's
    (1, 2), (2, 1), (2, 2), (4, 2) and (2, 1, 2) meshes)."""
    shape, names = tuple(int(d) for d in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    n = 1
    for d in shape:
        n *= d
    if n > group_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{group_size()}")
    return _mesh(shape, names, device)


def make_host_mesh(device="cuda"):
    """Degenerate (1, 1) ``("data", "model")`` mesh over rank 0."""
    return _mesh((1, 1), ("data", "model"), device)


def make_cohort_mesh(n_devices=None, device="cuda"):
    """1-D ``("data",)`` mesh over the first ``n_devices`` ranks of the
    default process group (all of them by default) — the client-axis
    sharding domain of the mesh-sharded
    :class:`~repro_torch.fl.cohort_engine.CohortEngine`.  Every rank of
    the group calls it (a group per mesh axis is made collectively)."""
    world = group_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} not in [1, {world}]")
    return _mesh((n,), ("data",), device)
