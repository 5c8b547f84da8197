"""The benchmark's files: every cell resolves by name to its
configuration, driver and metric readers, and ``BENCHMARK.json`` keeps
to the contract's shape."""
import json
import math
import os
import re

import pytest

from perfbench.lib import harness

BENCH = harness.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVER_API = ("build", "first_steps", "warm", "window", "end_to_end",
              "layer_data", "release", "program_readings", "reference",
              "judge", "notes", "control")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in seen
        seen.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        if e["name"].endswith("_roofline") or "_roofline." in e["name"] \
                or "mfu" in e["name"]:
            assert e["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    ctx = harness.context(cell, 1)
    assert ctx.workload["name"] == cell
    assert ctx.config["name"] == ctx.cell["config"]
    drv = harness.driver(ctx)
    for name in DRIVER_API:
        assert hasattr(drv, name), name
    assert ctx.workload["limits"]
    reported = [m["name"] for m in BENCH["end_to_end"]
                if harness.applies(m, cell)]
    assert "setup_s" in reported and len(reported) >= 2
    mine = [m for m in BENCH["per_layer"]
            if harness.applies(m, cell, reported)]
    assert mine
    for m in mine:
        assert m["moves"] in reported
        reader = harness.load_module(
            harness.BENCH / "metrics" / f"{m['name']}.py", "reader_" + m["name"])
        assert callable(reader.read)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert cfg["file"].startswith("perfbench/")
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert len(data["source"]) <= 200
    assert "assumed" in data and "deployment" in data
    assert any(c["config"] == cfg["name"] for c in BENCH["workloads"])


def test_one_chip_cells_at_most_a_quarter_on_four():
    four = sum(1 for c in BENCH["workloads"] if c["chips"] == 4)
    assert all(c["chips"] in (1, 4) for c in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(CELLS)))


def test_no_card_no_result(capsys):
    """Without the devices a cell asks for, the command exits non-zero
    and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    rc = harness.main(["--workload", CELLS[0], "--seed", "2147483649",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert "{" not in out.out


@pytest.mark.parametrize("cell", CELLS)
def test_host_threads_set_from_the_workload_file(cell, monkeypatch):
    for var in harness.THREAD_VARS:
        monkeypatch.delenv(var, raising=False)
    ctx = harness.context(cell, 1)
    n = harness.host_threads(ctx)
    for var in harness.THREAD_VARS:
        assert os.environ.get(var) == (str(n) if n else None)
