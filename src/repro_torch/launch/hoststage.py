"""Collectives for ranks that share one card, staged through host memory.

The port's counterpart of the reference's forced host devices: a way to
run the many-device steps where devices are few.  NCCL will not put two
ranks on one GPU, and ``gloo``'s ``all_gather_into_tensor`` on CUDA
tensors ends the rank on torch 2.11 (:mod:`.gloo_probe`), so DTensor's
steps on 2 to 8 ranks of one card have no route of their own.  This
backend gives them one: each collective

1. copies its CUDA inputs to host buffers (pinned);
2. runs over a CPU ``gloo`` backend of the same ranks, on those buffers
   (an all-gather as one broadcast from each rank);
3. copies the results back on the caller's current stream;
4. returns a finished ``Work``, so ``wait_tensor`` and DTensor's
   asynchronous collectives see ordinary completion.

It changes no numbers: every reduction is ``gloo``'s own on the staged
values (``ReduceOp.AVG``, which ``gloo`` lacks, is its sum divided by
the group's size).  CPU tensors take the same route through host copies
of their own, so the CPU tests exercise the staging too.

Registration: :func:`register` adds the backend under :data:`BACKEND`
for both devices (``torch.distributed.Backend.register_backend``); its
creator returns a ``ProcessGroup`` subclass, which c10d installs as the
group itself.  Then ``init_process_group("hoststage", ...)`` (or
:func:`.spawn.run_ranks` with ``backend="hoststage"``) starts a world,
and ``DeviceMesh`` makes its sub-groups over the same backend.  Nothing
falls back: a collective this backend does not serve raises.

:func:`stats` counts each collective a process dispatched, the bytes
it handed over (each rank's input) and the host seconds of its copies
and of ``gloo``; :func:`reset_stats` zeroes them.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch
import torch.distributed as dist

__all__ = ["BACKEND", "register", "stats", "reset_stats",
           "HostStagedGroup"]

BACKEND = "hoststage"
GLOO_THREADS, GLOO_DEVICES = 8, 2

_STATS: Dict[str, List[float]] = {}
_FIELDS = ("count", "bytes", "copy_s", "wire_s")


def stats() -> Dict[str, Dict[str, float]]:
    """``{collective: {"count", "bytes", "copy_s", "wire_s"}}`` since the
    last reset, in this process, over every group of this backend: the
    calls, the bytes each rank handed over (its inputs), and the host
    seconds spent copying between the card and host buffers (the copies
    back are enqueued, not waited for) and in ``gloo``."""
    return {k: dict(zip(_FIELDS, v)) for k, v in _STATS.items()}


def reset_stats() -> None:
    _STATS.clear()


class _Stage:
    """One collective's host buffers, counted and timed into
    :func:`stats` under ``name``."""

    def __init__(self, name: str, inputs):
        self.rec = _STATS.setdefault(name, [0, 0, 0.0, 0.0])
        self.rec[0] += 1
        self.rec[1] += sum(t.numel() * t.element_size() for t in inputs)

    def host(self, x: torch.Tensor) -> torch.Tensor:
        """A host copy of ``x`` (pinned when ``x`` is on a card)."""
        t0 = time.perf_counter()
        buf = self.empty(x)
        buf.copy_(x)
        self.rec[2] += time.perf_counter() - t0
        return buf

    @staticmethod
    def empty(x: torch.Tensor) -> torch.Tensor:
        """An uninitialized host buffer shaped as ``x``, for a result
        (pinned when ``x`` is on a card: pageable copies to and from the
        card are several times slower)."""
        return torch.empty(x.shape, dtype=x.dtype,
                           pin_memory=x.device.type == "cuda")

    def wire(self, *works) -> None:
        t0 = time.perf_counter()
        for work in works:
            work.wait()
        self.rec[3] += time.perf_counter() - t0

    def back(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``src`` (a host buffer) into ``dst`` on the current stream."""
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=dst.device.type == "cuda")
        self.rec[2] += time.perf_counter() - t0


def _done(result):
    """A ``Work`` that has already completed with ``result``."""
    from torch._C._distributed_c10d import _create_work_from_future
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _is_avg(opts) -> bool:
    return opts is not None and opts.reduceOp == dist.ReduceOp.AVG


def _as_sum(opts, cls):
    """``opts`` with ``ReduceOp.AVG`` made ``ReduceOp.SUM`` (a fresh
    ``cls``: the caller's options stay as they were)."""
    new = cls()
    new.reduceOp = dist.ReduceOp.SUM
    new.timeout = opts.timeout
    return new


class HostStagedGroup(dist.ProcessGroup):
    """A process group whose collectives stage through host memory over
    ``gloo`` (module docstring).  Made by c10d through :func:`register`'s
    creator, never by hand."""

    def __init__(self, store, rank: int, size: int, timeout):
        from torch._C._distributed_c10d import PrefixStore, ProcessGroupGloo
        super().__init__(rank, size)
        opts = ProcessGroupGloo._Options()
        opts._timeout = timeout
        # an all-gather's broadcasts run at once: more threads and two
        # connections a peer move them faster on one host
        opts._threads = GLOO_THREADS
        opts._devices = [ProcessGroupGloo.create_default_device()
                         for _ in range(GLOO_DEVICES)]
        self._gloo = ProcessGroupGloo(PrefixStore(f"{BACKEND}/", store),
                                      rank, size, opts)
        self._group_name = ""

    # c10d names the group after making it; functional collectives look
    # the group up by that name
    def _set_group_name(self, name: str) -> None:
        self._group_name = name
        super()._set_group_name(name)

    @property
    def group_name(self) -> str:
        return self._group_name

    def getBackendName(self) -> str:
        return BACKEND

    # -- all-gather ---------------------------------------------------------
    def _allgather_base(self, output, input, opts=None):
        st = _Stage("all_gather_into_tensor", [input])
        out = st.empty(output)
        slots = out.view(self.size(), -1)
        t0 = time.perf_counter()
        slots[self.rank()].copy_(input.reshape(-1))
        st.rec[2] += time.perf_counter() - t0
        st.wire(*self._broadcast_each(slots))
        st.back(output, out)
        return _done([output])

    def _broadcast_each(self, slots):
        """Slot ``r`` of ``slots`` broadcast from rank ``r``, all at once:
        an all-gather of copies only, and on one host faster than
        ``gloo``'s own all-gather."""
        from torch._C._distributed_c10d import BroadcastOptions
        works = []
        for r in range(self.size()):
            opts = BroadcastOptions()
            opts.rootRank = r
            works.append(self._gloo.broadcast([slots[r]], opts))
        return works

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for output, input in zip(outputs, inputs):
            self._allgather_base(output, input)
        return _done(outputs)

    # -- reductions ---------------------------------------------------------
    def _reduce_scatter_base(self, output, input, opts=None):
        from torch._C._distributed_c10d import ReduceScatterOptions
        st = _Stage("reduce_scatter_tensor", [input])
        out = st.empty(output)
        avg = _is_avg(opts)
        st.wire(self._gloo._reduce_scatter_base(
            out, st.host(input),
            _as_sum(opts, ReduceScatterOptions) if avg else opts))
        if avg:
            out /= self.size()
        st.back(output, out)
        return _done([output])

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for output, input in zip(outputs, inputs):
            self._reduce_scatter_base(output, input, opts)
        return _done(outputs)

    def allreduce(self, tensors, opts=None):
        from torch._C._distributed_c10d import AllreduceOptions
        st = _Stage("all_reduce", tensors)
        hosts = [st.host(t) for t in tensors]
        avg = _is_avg(opts)
        if opts is None:
            opts = AllreduceOptions()
        st.wire(self._gloo.allreduce(
            hosts, _as_sum(opts, AllreduceOptions) if avg else opts))
        for t, h in zip(tensors, hosts):
            if avg:
                h /= self.size()
            st.back(t, h)
        return _done(tensors)

    # -- the rest -----------------------------------------------------------
    def broadcast(self, tensors, opts=None):
        from torch._C._distributed_c10d import BroadcastOptions
        st = _Stage("broadcast", tensors)
        hosts = [st.host(t) for t in tensors]
        st.wire(self._gloo.broadcast(hosts, opts or BroadcastOptions()))
        for t, h in zip(tensors, hosts):
            st.back(t, h)
        return _done(tensors)

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        from torch._C._distributed_c10d import AllToAllOptions
        st = _Stage("all_to_all_single", [input])
        out = st.empty(output)
        st.wire(self._gloo.alltoall_base(out, st.host(input),
                                         output_split_sizes,
                                         input_split_sizes,
                                         opts or AllToAllOptions()))
        st.back(output, out)
        return _done([output])

    def barrier(self, opts=None):
        from torch._C._distributed_c10d import BarrierOptions
        st = _Stage("barrier", [])
        st.wire(self._gloo.barrier(opts or BarrierOptions()))
        return _done([])


def _create(store, rank, size, timeout):
    return HostStagedGroup(store, rank, size, timeout)


def register() -> None:
    """Register :data:`BACKEND` with ``torch.distributed`` for CPU and
    CUDA tensors (once a process; later calls do nothing)."""
    if hasattr(dist.Backend, BACKEND.upper()):
        return
    dist.Backend.register_backend(BACKEND, _create, devices=["cpu", "cuda"])
