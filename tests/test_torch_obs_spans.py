"""The port's ``phase`` spans: the host phases of a SAGIN round on the
tracer's wall clock, on the CPU.

One tiny batched region job runs one round traced (``device_timing``
on) and one untraced from the same seed.  The traced round holds one each
of ``plan``, ``optimize``, ``pools``, ``cohort_build``, ``aggregate``,
``losses`` and ``evaluate`` and one ``h2d`` a bucket dispatch; every
span lies inside the span its ``parent`` names; the ``round`` span has a
wall time that covers its direct children; tracing changes no loss and
no parameter; and ``Tracer.unix_ns`` puts a span on ``torch.profiler``'s
clock.
"""
import collections
import json

import pytest
import torch

from repro_torch.fl import FLConfig, RegionTrainer
from repro_torch.obs import NULL_TRACER, ObsConfig, Tracer, to_perfetto
from repro_torch.tree import tree_leaves

TINY = dict(dataset="mnist", n_devices=4, n_air=1, h_local=1,
            train_fraction=0.005, eval_size=64, seed=0,
            execution="batched", device="cpu")
ROUNDS = 1
PHASES = ("plan", "optimize", "pools", "cohort_build", "aggregate",
          "losses", "evaluate")
#: the instruments the training path no longer writes (their facts are
#: span attributes and ``CohortEngineStats``)
REMOVED = ("offload.bytes", "offload.samples_up", "offload.samples_down",
           "handover.count", "round.realized_latency_s", "round.overhead_s",
           "cohort.recompiled_signatures", "cohort.bucket_dispatches",
           "cohort.real_elements", "cohort.layout_elements",
           "cohort.padding_ratio", "cohort.dispatch_wall_s",
           "cohort.shard_imbalance", "cohort.shard_pad_clients")


def _run(obs):
    trainer = RegionTrainer(FLConfig(obs=obs, **TINY))
    for r in range(ROUNDS):
        trainer.step(r)
    return trainer


@pytest.fixture(scope="module")
def runs():
    """The traced and the untraced run, each built and stepped once for
    the whole module."""
    return _run(ObsConfig(path=None, device_timing=True)), _run(None)


@pytest.fixture(scope="module")
def traced(runs):
    return runs[0]


def _round_spans(trainer, r):
    return [s for s in trainer.tracer.spans if s.round == r]


def _parents(spans):
    """Each span that names a parent, with that parent: the round span,
    a phase by name, or (for ``h2d``) the bucket dispatch it precedes."""
    by_name = {s.name: s for s in spans if s.kind == "phase"}
    rnd = next(s for s in spans if s.kind == "round")
    dispatches = iter(s for s in spans if s.kind == "bucket_dispatch")
    out = []
    for s in spans:
        parent = s.attrs.get("parent")
        if parent is None:
            continue
        if parent == "round":
            p = rnd
        elif s.name == "h2d":
            p = next(dispatches)
            assert p.name == parent
        else:
            p = by_name[parent]
        out.append((s, p))
    return out


def test_one_round_emits_each_phase_once(traced):
    for r in range(ROUNDS):
        spans = _round_spans(traced, r)
        count = collections.Counter(s.name for s in spans
                                    if s.kind == "phase")
        n_dispatch = sum(1 for s in spans if s.kind == "bucket_dispatch")
        assert n_dispatch >= 1
        assert count == {**{p: 1 for p in PHASES}, "h2d": n_dispatch}
        assert sum(1 for s in spans if s.kind == "round") == 1
        by = {s.name: s for s in spans if s.kind == "phase"}
        assert by["optimize"].attrs["parent"] == "plan"
        assert by["optimize"].attrs["case"] in (0, 1, 2)
        assert by["cohort_build"].attrs["buckets"] == n_dispatch
        assert (by["cohort_build"].attrs["real"]
                <= by["cohort_build"].attrs["layout"])
        agg = by["aggregate"].attrs
        assert 1 <= agg["real_clients"] <= agg["clients"]
        n_params = sum(t.numel() for t in tree_leaves(traced.params))
        assert agg["bytes"] == (agg["clients"] + 1) * n_params * 4
        assert by["evaluate"].attrs["samples"] == TINY["eval_size"]
        assert all(s.attrs["bytes"] > 0 for s in spans if s.name == "h2d")
        assert all(s.dur_sim == 0.0 and s.dur_wall > 0
                   for s in spans if s.kind == "phase")


def test_children_lie_inside_their_parents(traced):
    for r in range(ROUNDS):
        spans = _round_spans(traced, r)
        pairs = _parents(spans)
        assert len(pairs) >= len(PHASES) + 2
        for child, parent in pairs:
            assert parent.t_wall <= child.t_wall, (child, parent)
            assert (child.t_wall + child.dur_wall
                    <= parent.t_wall + parent.dur_wall), (child, parent)
        rnd = next(s for s in spans if s.kind == "round")
        plan = next(s for s in spans if s.name == "plan")
        assert rnd.t_wall < plan.t_wall


def test_round_wall_covers_its_direct_children(traced):
    for r in range(ROUNDS):
        spans = _round_spans(traced, r)
        rnd = next(s for s in spans if s.kind == "round")
        children = [s for s in spans if s.attrs.get("parent") == "round"]
        assert {s.kind for s in children} == {"phase", "bucket_dispatch"}
        assert rnd.dur_wall >= sum(s.dur_wall for s in children) > 0


def test_tracing_changes_no_loss_and_no_parameter(runs):
    traced, plain = runs
    assert plain.tracer is NULL_TRACER and not plain.tracer.spans
    assert plain.result.losses == traced.result.losses
    assert plain.result.accuracies == traced.result.accuracies
    for a, b in zip(tree_leaves(plain.params),
                    tree_leaves(traced.params)):
        assert torch.equal(a, b)


def test_training_path_writes_none_of_the_removed_instruments(traced):
    snap = traced.tracer.metrics.snapshot()
    assert not set(REMOVED) & set(snap)


def test_null_tracer_phase_is_one_shared_no_op():
    ph = NULL_TRACER.phase("plan", device=torch.device("cpu"))
    assert ph is NULL_TRACER.phase("evaluate", parent="C4xH1xB32")
    with ph as inner:
        inner.set(bytes=1)
    assert not NULL_TRACER.spans


def test_phase_parent_nests_and_a_raising_block_records_nothing():
    tr = Tracer(ObsConfig())
    with tr.phase("outer"):
        with tr.phase("inner") as ph:
            ph.set(n=3)
            ph.set(m=4)
        with tr.phase("copy", parent="C4xH1xB32"):
            pass
    with pytest.raises(RuntimeError):
        with tr.phase("broken"):
            raise RuntimeError("x")
    with tr.phase("after"):
        pass
    got = {s.name: s.attrs for s in tr.spans}
    assert got == {"inner": {"parent": "outer", "n": 3, "m": 4},
                   "copy": {"parent": "C4xH1xB32"},
                   "outer": {"parent": "round"},
                   "after": {"parent": "round"}}


def test_unix_clock_matches_the_profilers(tmp_path):
    tr = Tracer(ObsConfig(path=str(tmp_path / "t.jsonl")))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("warm"):
            pass
        with tr.phase("probe") as ph:
            with torch.profiler.record_function("probe.label"):
                ph.set(n=1)
    span = next(s for s in tr.spans if s.name == "probe")
    ev = next(e for e in prof.profiler.kineto_results.events()
              if e.name() == "probe.label")
    assert abs(ev.start_ns() - tr.unix_ns(span.t_wall)) < 1_000_000
    assert tr.unix_ns(1.5) - tr.unix_ns(0.0) == 1_500_000_000
    assert to_perfetto(tr.spans, tr.epoch_unix_ns)["otherData"] == {
        "schema": "repro-trace/1", "epoch_unix_ns": tr.epoch_unix_ns}
    tr.flush()
    with open(tmp_path / "t.perfetto.json") as fh:
        assert (json.load(fh)["otherData"]["epoch_unix_ns"]
                == tr.epoch_unix_ns)
