"""The readers of the program's ``phase`` spans, on hand-built spans:
each gives the value worked out by hand, and None where the program
emits no such span (a program that predates them)."""
import pytest

from perfbench.lib import harness

GIB = 2 ** 30
#: (kind, name, round, dur_wall, attrs) of two rounds
ROWS = [
    ("round", "r/r0", 0, 1.00, {}),
    ("phase", "plan", 0, 0.20, {"parent": "round"}),
    ("phase", "optimize", 0, 0.10, {"parent": "plan", "case": 2}),
    ("phase", "pools", 0, 0.01, {"parent": "round"}),
    ("phase", "cohort_build", 0, 0.15, {"parent": "round"}),
    ("phase", "h2d", 0, 0.02, {"parent": "C4xH5xB32", "bytes": GIB // 2}),
    ("bucket_dispatch", "C4xH5xB32", 0, 0.40,
     {"parent": "round", "real": 60, "layout": 64}),
    ("phase", "aggregate", 0, 0.05, {"parent": "round"}),
    ("phase", "losses", 0, 0.01, {"parent": "round"}),
    ("phase", "evaluate", 0, 0.08, {"parent": "round"}),
    ("round", "r/r1", 1, 1.20, {}),
    ("phase", "plan", 1, 0.30, {"parent": "round"}),
    ("phase", "optimize", 1, 0.20, {"parent": "plan", "case": 1}),
    ("phase", "pools", 1, 0.02, {"parent": "round"}),
    ("phase", "cohort_build", 1, 0.25, {"parent": "round"}),
    ("phase", "h2d", 1, 0.03, {"parent": "C8xH5xB32", "bytes": GIB}),
    ("bucket_dispatch", "C8xH5xB32", 1, 0.45,
     {"parent": "round", "real": 200, "layout": 256}),
    ("phase", "aggregate", 1, 0.07, {"parent": "round"}),
    ("phase", "losses", 1, 0.01, {"parent": "round"}),
    ("phase", "evaluate", 1, 0.06, {"parent": "round"}),
]
EXPECTED = {
    "plan_ms.sagin": 250.0,          # (200 + 300) / 2
    "offload_opt_ms.sagin": 150.0,   # (100 + 200) / 2
    "gather_ms.sagin": 200.0,        # (150 + 250) / 2
    "h2d_gib_s.sagin": 30.0,         # 1.5 GiB / 0.05 s
    "aggregate_ms.sagin": 60.0,      # (50 + 70) / 2
    "eval_ms.sagin": 70.0,           # (80 + 60) / 2
    "round_self_ms.sagin": 70.0,     # (1.00 - 0.90 + 1.20 - 1.16) / 2
}


def _span(kind, name, r, dur, attrs):
    return {"kind": kind, "name": name, "region": "r", "round": r,
            "t_sim": 0.0, "dur_sim": 0.0, "t_wall": 0.0, "dur_wall": dur,
            "attrs": dict(attrs)}


def _data(rows):
    return {"spans": [_span(*row) for row in rows],
            "rounds": [{"round": 0, "t0": 0.0, "t1": 1.0},
                       {"round": 1, "t0": 1.0, "t1": 2.2}]}


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "reader_" + name)


def test_the_readers_are_declared():
    declared = {m["name"]: m for m in harness.benchmark()["per_layer"]}
    for name in EXPECTED:
        m = declared[name]
        assert m["source"] == "program_span" and m["moves"] == "round_s"
        assert m["workloads"] == ["sagin_round.vgg11.adaptive"]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_value_by_hand(name):
    assert _reader(name).read(_data(ROWS)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_none_without_phase_spans(name):
    """A program without ``phase`` spans: a ``round`` span without a
    wall, dispatches without a parent."""
    old = [("round", "r/r0", 0, 0.0, {}),
           ("bucket_dispatch", "C4xH5xB32", 0, 0.40,
            {"real": 60, "layout": 64})]
    reader = _reader(name)
    assert reader.read(_data(old)) is None
    assert reader.read({}) is None
