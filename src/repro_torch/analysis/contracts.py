"""Runtime contracts: the linter's invariants, enforced while running.

The counterpart of the reference's ``analysis/contracts.py`` in PyTorch's
terms, with its names and its label-bearing messages:

* :func:`no_recompile` — no (or at most ``allow``) new programs built
  inside the block.  PyTorch runs eagerly and builds a program only
  where the port asks for one: a kernel library that nvcc compiles or
  that is loaded for the first time (``kernels/build.py`` counts both),
  and a new ``torch.compile`` graph (dynamo's own count).  Both counts
  are the port's to read, so the contract is always enforced; reading
  them costs nothing on the warm path.  The port's main paths capture no
  CUDA graph (only the ``compare_builds`` timing tools do), so there is
  no capture site to count.
* :func:`assert_donated` — every watched tensor was written in place
  inside the block: PyTorch's counterpart of a donated buffer, told from
  the tensor's version counter.
* :func:`nan_tripwire` — raises at the ATen op (or the hand-written
  kernel) whose output first holds a NaN (optionally inf).
* :func:`assert_finite` — an eager check of a tree's leaves.

Violations raise :class:`ContractViolation` (an ``AssertionError``
subclass, so pytest reports them natively).
"""
from __future__ import annotations

import contextlib
import sys
import warnings
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves as _out_leaves

from ..kernels.build import programs_built
from ..tree import tree_leaves


class ContractViolation(AssertionError):
    """A runtime invariant asserted by repro_torch.analysis.contracts
    failed."""


# ---------------------------------------------------------------------------
# no_recompile
# ---------------------------------------------------------------------------
class RecompileCount:
    """Live view of the program count inside a ``no_recompile`` block
    (it counts on after the block: read it there).  Both counts it reads
    are the port's own, so ``enforced`` is always true."""

    enforced = True

    def __init__(self, get):
        self._get = get        # zero-arg count reader

    @property
    def count(self) -> int:
        return int(self._get())


def _programs() -> int:
    """Kernel libraries compiled or first loaded, plus ``torch.compile``
    graphs, so far in this process.  Dynamo's counters start at 0 when it
    is imported, so a process that never imported it has made none."""
    n = programs_built()
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is not None:
        n += int(utils.counters["stats"]["unique_graphs"])
    return n


@contextlib.contextmanager
def no_recompile(allow: int = 0,
                 label: Optional[str] = None) -> Iterator[RecompileCount]:
    """Assert that at most ``allow`` new programs are built in here.

    A *program* is a kernel library compiled by nvcc or loaded for the
    first time, or a new ``torch.compile`` graph: the warm path of a
    round loop builds none, so any count above ``allow`` means a shape,
    dtype or source changed on it.  Building and loading one library
    scores 2.  Yields a :class:`RecompileCount` whose ``.count`` is
    readable after the block.
    """
    start = _programs()
    view = RecompileCount(lambda: _programs() - start)
    yield view
    n = view.count
    if n > allow:
        where = f" [{label}]" if label else ""
        raise ContractViolation(
            f"no_recompile{where}: {n} new program(s) built inside a "
            f"block that allows {allow} — a kernel library compiled or "
            f"loaded, or a torch.compile graph (shape, dtype or guard) "
            f"changed on the warm path")


# ---------------------------------------------------------------------------
# assert_donated
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def assert_donated(*trees, label: Optional[str] = None,
                   strict: Optional[bool] = None) -> Iterator[None]:
    """Assert every tensor in ``trees`` was written in place inside the
    block.

    PyTorch has no donation: a step that updates its params in place (the
    port's ``donate=True``, e.g. ``launch/train.py``'s ``_donated_step``)
    is what keeps memory at one copy.  Every in-place write bumps a
    tensor's version counter (``_version``, shared with its views), so a
    watched tensor whose counter did not move was not written and the
    step quietly ran out of place.  The reference downgrades the failure
    to a warning on the CPU, where jax documents donation as a no-op; an
    in-place write behaves the same on every device, so here
    ``strict=None`` means strict everywhere, and only ``strict=False``
    warns instead.
    """
    leaves = [leaf for tree in trees for leaf in tree_leaves(tree)
              if isinstance(leaf, torch.Tensor)]
    versions = [leaf._version for leaf in leaves]
    yield
    live = [leaf for leaf, v in zip(leaves, versions) if leaf._version == v]
    if not live:
        return
    where = f" [{label}]" if label else ""
    devices = sorted({str(leaf.device) for leaf in live})
    msg = (f"assert_donated{where}: {len(live)}/{len(leaves)} watched "
           f"tensor(s) still live after the block — not written in place, "
           f"so the step ran out of place (device: {', '.join(devices)})")
    if strict is None or strict:
        raise ContractViolation(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


# ---------------------------------------------------------------------------
# nan_tripwire / assert_finite
# ---------------------------------------------------------------------------
_TRIPWIRES: list = []
# ops whose output is uninitialized memory (a kernel's output, before it
# writes it): no value to check
_UNWRITTEN = {torch.ops.aten.empty.memory_format,
              torch.ops.aten.empty_like.default,
              torch.ops.aten.empty_strided.default,
              torch.ops.aten.new_empty.default,
              torch.ops.aten.new_empty_strided.default}


def _bad(t: torch.Tensor, infs: bool) -> bool:
    if not (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.device.type != "meta" and t.numel()):
        return False
    return bool((~torch.isfinite(t) if infs else torch.isnan(t)).any())


class _Tripwire(TorchDispatchMode):
    """Checks every floating output of every ATen op that writes one."""

    def __init__(self, infs: bool):
        super().__init__()
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # a view shows its base's values and an empty tensor none: neither
        # produced what it holds
        if not func.is_view and func not in _UNWRITTEN:
            for i, t in enumerate(_out_leaves(out)):
                if _bad(t, self.infs):
                    raise ContractViolation(
                        f"nan_tripwire: {func} produced NaN"
                        f"{'/inf' if self.infs else ''} in output {i} "
                        f"(shape {tuple(t.shape)}, {t.dtype})")
        return out


def check_kernel_outputs(name: str, *outputs: torch.Tensor) -> None:
    """Raise naming kernel ``name`` if one of ``outputs`` holds NaN (or
    inf, per the innermost tripwire).  The kernels write through
    ``ctypes`` into tensors allocated beforehand, so the dispatch mode
    sees the allocation and never the write: their dispatchers call this
    after every launch, and it returns at once unless a tripwire is
    armed."""
    if not _TRIPWIRES:
        return
    infs = _TRIPWIRES[-1]
    with _disable_current_modes():      # the check's own ops, unchecked
        bad = next((i for i, t in enumerate(outputs) if _bad(t, infs)),
                   None)
    if bad is not None:
        t = outputs[bad]
        raise ContractViolation(
            f"nan_tripwire: kernel {name} produced NaN"
            f"{'/inf' if infs else ''} in output {bad} "
            f"(shape {tuple(t.shape)}, {t.dtype})")


@contextlib.contextmanager
def nan_tripwire(infs: bool = True) -> Iterator[None]:
    """Raise at the op that produces a NaN (optionally inf) in here.

    A ``TorchDispatchMode`` checks every floating output of every ATen op
    in the block, forward and backward, and anomaly detection
    (``torch.autograd.set_detect_anomaly``) keeps the forward's trace for
    a backward that fails; the hand-written kernels' outputs are checked
    by their dispatchers (:func:`check_kernel_outputs`).  Every check
    reads its value back to the host, so keep this off hot paths.  The
    previous settings are restored on exit.  With ``infs`` an inf trips
    it too, an intended one included (a ``-inf`` mask in a plain
    attention).
    """
    _TRIPWIRES.append(infs)
    try:
        with torch.autograd.set_detect_anomaly(True), _Tripwire(infs):
            yield
    finally:
        _TRIPWIRES.pop()


def assert_finite(tree, label: Optional[str] = None) -> None:
    """Eager check that every leaf of ``tree`` is finite.

    The explicit complement to :func:`nan_tripwire` for values computed
    *before* entering a guarded block (e.g. params arriving over an ISL
    merge): one pass over the leaves and one read back to the host;
    raises :class:`ContractViolation` naming the offending leaf count.
    Integer leaves are ignored.
    """
    flags = [~torch.isfinite(leaf).all() for leaf in tree_leaves(tree)
             if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    bad = (int(torch.stack([f.to(flags[0].device) for f in flags]).sum())
           if flags else 0)
    if bad:
        where = f" [{label}]" if label else ""
        raise ContractViolation(
            f"assert_finite{where}: {bad} leaf array(s) contain "
            f"NaN/inf")
