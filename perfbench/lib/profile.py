"""The traced run's profile and its reduction.

``torch.profiler`` records the card's kernels, copies and sets and the
host's CUDA runtime calls over the profiled rounds (host operators are
left out on a card: recording them doubled the FL step's round time).
:func:`reduce` turns the raw events into what the per-layer readers and
the result's ``breakdown`` read: the card's busy seconds (the union of
its intervals, so overlapping kernels count once), the profile's length
(from the :data:`WINDOW` label where host operators were recorded, else
from its first event to its last), every device event, device time by
name, and the idle gaps named by the innermost host event running at
their middle ("host: no CUDA call" where the host was in Python).
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

WINDOW = "perfbench.window"
TOP = 10
GAPS_NAMED = 400        # the longest gaps each get a host name
SCAN_BACK = 4000        # host events searched back for the enclosing one


@contextlib.contextmanager
def capture(enabled: bool):
    """Profile the block when ``enabled``: the card's activity where
    there is a card, the host's operators where there is none; yields the
    profiler, or None."""
    if not enabled:
        yield None
        return
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA
            if torch.cuda.is_available()
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=False,
                                with_stack=False,
                                profile_memory=False) as prof:
        yield prof


def _times(ev) -> Tuple[int, int]:
    """(start, end) of a kineto event in nanoseconds."""
    if hasattr(ev, "start_ns"):
        start, dur = ev.start_ns(), ev.duration_ns()
    else:  # older builds count microseconds
        start, dur = ev.start_us() * 1000, ev.duration_us() * 1000
    return int(start), int(start) + int(dur)


def raw_events(prof) -> Tuple[List[Tuple[int, int, str]],
                              List[Tuple[int, int, str]]]:
    """(device events, host events) as (start_ns, end_ns, name).  The
    profiler mirrors every host label (``record_function``) as a range
    on the device's timeline; those mirrors are no device work and are
    dropped."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        t0, t1 = _times(ev)
        if ev.device_type() == DeviceType.CUDA:
            dev.append((t0, t1, ev.name()))
        else:
            host.append((t0, t1, ev.name()))
    labels = {name for _, _, name in host}
    return [d for d in dev if d[2] not in labels], host


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, merged intervals."""
    out: List[List[int]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host event running at
    each gap's middle ("host: no CUDA call" where none is)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    named: Dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        best = None
        for j in range(i, max(-1, i - SCAN_BACK), -1):
            h0, h1, name = host[j]
            if h1 >= mid and name != WINDOW:
                if best is None or (h1 - h0) < (best[1] - best[0]):
                    best = host[j]
        key = best[2] if best is not None else "host: no CUDA call"
        named[key] = named.get(key, 0.0) + (g1 - g0) * 1e-9
    return named


def reduce(prof) -> dict:
    """The window's device activity: ``window_s``, ``busy_s``,
    ``events`` (device events inside the window, as (start_ns, end_ns,
    name)), ``by_name`` (device seconds by event name), and ``breakdown``
    (the top device operations and idle gaps)."""
    dev, host = raw_events(prof)
    marks = [(t0, t1) for t0, t1, name in host if name == WINDOW]
    if marks:
        w0, w1 = marks[0]
    else:   # no host operators recorded: the profile's own span
        every = dev + host
        if not every:
            raise RuntimeError("the profile holds no event")
        w0 = min(e[0] for e in every)
        w1 = max(e[1] for e in every)
    inside = [(max(t0, w0), min(t1, w1), n) for t0, t1, n in dev
              if t1 > w0 and t0 < w1]
    busy = union([(t0, t1) for t0, t1, _ in inside])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    by_name: Dict[str, float] = {}
    for t0, t1, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (t1 - t0) * 1e-9
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host_in = [h for h in host if h[1] > w0 and h[0] < w1]
    named = _name_gaps(gaps, host_in)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "events": inside,
        "by_name": by_name,
        "breakdown": {"device_ops": [[n, s] for n, s in top_ops],
                      "idle_gaps": [[n, s] for n, s in top_gaps]},
    }


def kernel_seconds(events, match) -> Tuple[float, int]:
    """(device seconds, launches) of the events whose name ``match``
    accepts."""
    secs, n = 0.0, 0
    for t0, t1, name in events:
        if match(name):
            secs += (t1 - t0) * 1e-9
            n += 1
    return secs, n
