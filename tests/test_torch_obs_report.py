"""The port's trace report against the reference's, on the CPU.

``repro_torch.obs.report`` is a copy of ``repro.obs.report``: for one
trace both packages' ``analyze`` give the same report structure, the
CLIs the same ``--json`` document, and ``render`` the same text.  That
is checked on a port trace holding training, serving and ``resume``
spans, on a trace of the port's ``python -m repro_torch.serve``, and on
a reference trace.  The CLI's exit codes, its ``perfetto`` subcommand,
the span-vocabulary sync and the serving section are the reference's
tests, ported.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.fl import FLConfig as JaxFLConfig
from repro.obs import ObsConfig as JaxObsConfig
from repro.obs import load_jsonl as jax_load_jsonl
from repro.obs.__main__ import main as jax_obs_main
from repro.obs.report import analyze as jax_analyze
from repro.obs.report import render as jax_render
from repro.scenarios import get_scenario as jax_get_scenario
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeGateway as JaxServeGateway
from repro.sim import SAGINEngine as JaxEngine
from repro_torch.checkpoint import restore_engine, save_engine
from repro_torch.fl import FLConfig
from repro_torch.obs import (HANDLED_KINDS, PERFETTO_KINDS, SPAN_KINDS,
                             ObsConfig, Tracer, analyze, load_jsonl, render)
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.report import SERVING_KINDS
from repro_torch.scenarios import get_scenario
from repro_torch.serve import ServeConfig, ServeGateway
from repro_torch.serve.__main__ import main as serve_main
from repro_torch.sim import SAGINEngine

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dataset="mnist", n_devices=4, n_air=1, h_local=1,
            train_fraction=0.005, eval_size=64, seed=0,
            execution="sequential")


def two_region_scenario(get=get_scenario):
    base = get("multi_region")
    return dataclasses.replace(base, name="_report_test",
                               regions=base.regions[:2])


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A port trace with training, resume, merge and serving spans: one
    round, a checkpoint, a restored engine's second round, a session."""
    d = tmp_path_factory.mktemp("port_trace")
    seg = SAGINEngine(two_region_scenario(),
                      fl=FLConfig(device="cpu", **TINY))
    seg.run(1, final_merge=False)
    save_engine(seg, str(d / "ckpt"))
    path = str(d / "trace.jsonl")
    eng = SAGINEngine(two_region_scenario(),
                      fl=FLConfig(device="cpu", obs=ObsConfig(path=path),
                                  **TINY))
    restore_engine(eng, str(d / "ckpt"))
    eng.run(1)
    ServeGateway(eng, serve=ServeConfig(base_rate=1.0)).run(60.0)
    return path


@pytest.fixture(scope="module")
def reference_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref_trace") / "trace.jsonl")
    eng = JaxEngine(two_region_scenario(jax_get_scenario),
                    fl=JaxFLConfig(obs=JaxObsConfig(path=path), **TINY))
    eng.run(1)
    JaxServeGateway(eng, serve=JaxServeConfig(base_rate=1.0)).run(60.0)
    return path


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _assert_same_report(path, capsys):
    rep, jrep = analyze(load_jsonl(path)), jax_analyze(jax_load_jsonl(path))
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert render(rep) == jax_render(jrep)
    for argv in (["report", path], ["report", path, "--json"],
                 ["report", path, "--top", "1"]):
        assert _cli(obs_main, argv, capsys) == _cli(jax_obs_main, argv,
                                                    capsys)
    return rep


def test_port_trace_reports_identically(port_trace, capsys):
    rep = _assert_same_report(port_trace, capsys)
    assert {"round", "merge", "resume", "request",
            "serve_batch"} <= set(rep.kinds)
    assert rep.resumes == 1 and rep.serving is not None
    text = render(rep)
    assert "resilience (" in text and "1 resume(s)" in text
    assert "serving (" in text


def test_reference_trace_reports_identically(reference_trace, capsys):
    rep = _assert_same_report(reference_trace, capsys)
    assert rep.serving is not None and rep.merges >= 1


def test_serve_cli_trace_reports_identically(tmp_path, capsys):
    """``python -m repro_torch.serve --device cpu`` writes a trace that
    both packages' report CLIs print the same way, serving included."""
    path = str(tmp_path / "T.jsonl")
    rc, out = _cli(serve_main, ["--device", "cpu", "--scenario",
                                "multi_region", "--rounds", "1",
                                "--duration", "60", "--trace", path],
                   capsys)
    assert rc == 0 and "router=min_rt" in out and "served=" in out
    rep = _assert_same_report(path, capsys)
    assert "serving (" in render(rep) and len(rep.regions) == 4


def test_serve_cli_rejects_bad_arguments(capsys):
    assert serve_main(["--device", "cpu", "--scenario", "nowhere"]) == 2
    assert "nowhere" in capsys.readouterr().err


def test_report_cli_exit_codes(port_trace, tmp_path, capsys):
    rc, out = _cli(obs_main, ["report", port_trace], capsys)
    assert rc == 0
    assert "indiana" in out and "nairobi" in out
    assert "latency breakdown" in out
    rc, out = _cli(obs_main, ["report", port_trace, "--json"], capsys)
    assert rc == 0
    assert json.loads(out)["n_spans"] == len(load_jsonl(port_trace))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert obs_main(["report", str(empty)]) == 1
    assert obs_main(["report", str(tmp_path / "missing.jsonl")]) == 2
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json}\n")
    assert obs_main(["report", str(bad)]) == 2
    assert obs_main([]) == 2


def test_perfetto_cli_subcommand(port_trace, tmp_path, capsys):
    out = str(tmp_path / "conv.perfetto.json")
    assert obs_main(["perfetto", port_trace, "--out", out]) == 0
    capsys.readouterr()
    with open(out) as fh:
        pf = json.load(fh)
    assert pf["otherData"]["schema"] == "repro-trace/1"
    assert len(pf["traceEvents"]) > 0


def test_obs_module_runs_as_a_program(port_trace):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", port_trace],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert "serving (" in proc.stdout and "resilience (" in proc.stdout


def test_span_vocabulary_three_way_sync():
    assert set(SPAN_KINDS) == set(PERFETTO_KINDS.keys()) == set(HANDLED_KINDS)
    assert SERVING_KINDS <= HANDLED_KINDS
    assert {"request", "serve_batch"} <= SERVING_KINDS
    assert all(g for g in PERFETTO_KINDS.values())


def test_report_serving_section():
    tr = Tracer(ObsConfig())
    tr.span("round", "indiana/r0", region="indiana", round=0,
            t_sim=0.0, dur_sim=100.0, case=2, acc=0.5)
    for k in range(10):
        tr.span("request", f"req{k}", region="indiana", round=-1,
                t_sim=float(k), dur_sim=0.5 + 0.01 * k,
                route="sat" if k % 2 else "isl", wait_s=0.1,
                correct=(k % 4 != 0))
    tr.span("serve_batch", "sat0/b1", region="indiana", round=-1,
            t_sim=10.0, dur_sim=0.2, node="sat0", n_real=10, n_pad=16,
            queue_after=0)
    rep = analyze(tr.spans)
    sv = rep.serving
    assert sv is not None
    assert sv.requests == 10 and sv.batches == 1
    assert sv.latency_p99 >= sv.latency_p50 > 0
    assert sv.wait_mean == pytest.approx(0.1)
    assert sv.served_accuracy == pytest.approx(0.7)
    assert sv.by_region == {"indiana": 10}
    assert sv.by_target == {"sat": 5, "isl": 5}
    assert sv.mean_batch == pytest.approx(10.0)
    assert sv.fill == pytest.approx(10 / 16)
    # serving spans stay out of the TRAINING tables and run_end
    assert rep.regions[0].rounds == 1
    text = render(rep)
    assert "serving" in text
    assert "p99_s" in text and "fill" in text and "routes:" in text
