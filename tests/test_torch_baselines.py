"""The port's comparison schemes (Section VI-A) against the reference's:
NumPy orchestration in both packages, so every realized latency is
identical."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.fl import baselines as JB
from repro_torch.core.strategies import resolve_strategy
from repro_torch.fl import baselines as B

ROOT = Path(__file__).resolve().parents[1]


def test_schemes_and_hooks_match_reference():
    assert B.ALL_SCHEMES == JB.ALL_SCHEMES
    assert B.BASELINES == JB.BASELINES
    for name in B.ALL_SCHEMES:
        assert B.SCHEME_HOOKS[name] is resolve_strategy(name)


@pytest.mark.parametrize("kw", [dict(), dict(n_rounds=2, n_devices=6,
                                             n_air=2, seed=3)])
def test_compare_schemes_identical(kw):
    got, want = B.compare_schemes(**kw), JB.compare_schemes(**kw)
    assert list(got) == list(want) == B.ALL_SCHEMES
    assert got == want


def test_run_scheme_records_identical():
    got = B.run_scheme("static", n_rounds=3, n_devices=6, n_air=2, seed=1)
    want = JB.run_scheme("static", n_rounds=3, n_devices=6, n_air=2, seed=1)
    assert [(r.plan.case, r.latency, r.realized_latency) for r in got] \
        == [(r.plan.case, r.latency, r.realized_latency) for r in want]


def test_cli_prints_every_scheme():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.fl.baselines"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120, check=True)
    rows = proc.stdout.splitlines()[1:]
    assert [r.split()[0] for r in rows] == B.ALL_SCHEMES
    assert "RuntimeWarning" not in proc.stderr
