"""The port's static analyzer against the reference's.

``repro_torch.analysis`` is a copy of ``repro.analysis`` (AST code only,
no JAX) whose OBS001 also resolves ``repro_torch.obs``.  Both scanners
run on the same inputs and must give the same findings (path, rule,
line, column, severity, message): over the reference package, the
benchmarks and the examples; over every snippet that
``tests/test_analysis.py`` lints, one case each (read from that file's
syntax tree, so a snippet added there is covered here); and through the
CLI (exit codes, ``--list-rules``).  The port's own package scans clean.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import scan as ref_scan
from repro.analysis.__main__ import main as ref_cli
from repro_torch.analysis import DEFAULT_BASELINE, scan
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis import findings as port_findings

ROOT = Path(__file__).resolve().parents[1]


def _triples(findings):
    return [(f.path, f.rule, f.line, f.col, f.severity, f.message)
            for f in findings]


def _snippets():
    """Every ``lint(tmp_path, SRC, name=..., rules=...)`` call of
    tests/test_analysis.py, SRC a literal or a local bound to one:
    (case id, source, file name, rules)."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        local = {}
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)):
                local[node.targets[0].id] = node.value.value
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Name) and n.func.id == "lint"]
        for i, call in enumerate(sorted(calls, key=lambda c: c.lineno)):
            src = call.args[1]
            src = (src.value if isinstance(src, ast.Constant)
                   else local[src.id])
            kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
            out.append((f"{fn.name}-{i}", src, kw.get("name", "lib/mod.py"),
                        kw.get("rules")))
    return out


SNIPPETS = _snippets()


def test_snippets_found():
    assert len(SNIPPETS) >= 50
    assert {name.split("_")[1] for name, *_ in SNIPPETS} >= {
        "rng001", "rng002", "rng003", "jit001", "jit002", "jit003",
        "don001", "host001", "obs001", "shard001", "res001", "time001"}


@pytest.mark.parametrize("case,src,name,rules", SNIPPETS,
                         ids=[s[0] for s in SNIPPETS])
def test_snippet_findings_equal_the_reference(tmp_path, case, src, name,
                                              rules):
    f = tmp_path / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(src))
    want = ref_scan([f], root=tmp_path, rule_ids=rules)
    got = scan([f], root=tmp_path, rule_ids=rules)
    assert _triples(got) == _triples(want)


def test_cross_module_donor_equal_the_reference(tmp_path):
    (tmp_path / "lib").mkdir()
    (tmp_path / "lib" / "kernels.py").write_text(
        "import jax\nfused_step = jax.jit(lambda p, x: p, "
        "donate_argnums=(0,))\n")
    (tmp_path / "lib" / "driver.py").write_text(
        "from lib.kernels import fused_step\n\n\ndef train(params, x):\n"
        "    new = fused_step(params, x)\n    return params['w'], new\n")
    got = scan([tmp_path / "lib"], root=tmp_path)
    assert _triples(got) == _triples(ref_scan([tmp_path / "lib"],
                                              root=tmp_path))
    assert [(f.rule, f.path) for f in got] == [("DON001", "lib/driver.py")]


def test_repo_scan_equals_the_reference():
    paths = [ROOT / "src" / "repro", ROOT / "benchmarks", ROOT / "examples"]
    want = ref_scan(paths, root=ROOT)
    got = scan(paths, root=ROOT)
    assert want, "the reference finds something in its own tree"
    assert _triples(got) == _triples(want)


def test_obs001_sees_the_ports_tracer(tmp_path):
    """A call into ``repro_torch.obs`` inside a jitted function is the
    port's finding alone: the reference resolves ``repro.obs`` only."""
    src = """
        import jax
        from repro_torch.obs import resolve_obs

        @jax.jit
        def step(x):
            resolve_obs(None)
            return x
    """
    f = tmp_path / "lib" / "mod.py"
    f.parent.mkdir(parents=True)
    f.write_text(textwrap.dedent(src))
    assert [g.rule for g in scan([f], root=tmp_path)] == ["OBS001"]
    assert ref_scan([f], root=tmp_path) == []
    # the reference's own package still resolves as before
    f.write_text(textwrap.dedent(src.replace("repro_torch.obs",
                                             "repro.obs")))
    assert (_triples(scan([f], root=tmp_path))
            == _triples(ref_scan([f], root=tmp_path)))
    # the port's phase helper on a tracer, which the reference's tracer
    # does not have
    f.write_text(textwrap.dedent("""
        import jax

        @jax.jit
        def step(x, tracer):
            with tracer.phase("plan"):
                return x
    """))
    assert [g.rule for g in scan([f], root=tmp_path)] == ["OBS001"]
    assert ref_scan([f], root=tmp_path) == []


BAD_SRC = """
import numpy as np
def draw(n):
    return np.random.rand(n)
"""
WARN_SRC = ("import jax\n\n\ndef build():\n"
            "    return jax.random.PRNGKey(7)\n")


def test_cli_exit_codes_equal_the_reference(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "lib.py").write_text(BAD_SRC)
    (tmp_path / "warn.py").write_text(WARN_SRC)
    (tmp_path / "ok.py").write_text("def f(rng):\n    return rng.normal()\n")
    argvs = [["ok.py"], ["lib.py"], ["lib.py", "--format", "json"],
             ["warn.py", "--no-baseline"],
             ["warn.py", "--no-baseline", "--strict"],
             ["missing_dir_xyz"], ["lib.py", "--select", "NOPE01"],
             ["lib.py", "--select", "JIT001", "--no-baseline"],
             ["lib.py", "--select", "RNG001", "--no-baseline"]]
    for argv in argvs:
        want = ref_cli(argv)
        want_out = capsys.readouterr()
        got = cli(argv)
        got_out = capsys.readouterr()
        assert got == want, argv
        assert got_out.out == want_out.out, argv
    # a baseline either CLI writes, the other reads (format and default
    # file name kept)
    assert port_findings.DEFAULT_BASELINE == DEFAULT_BASELINE
    assert cli(["lib.py", "--write-baseline"]) == 0
    assert (tmp_path / DEFAULT_BASELINE).exists()
    capsys.readouterr()
    assert ref_cli(["lib.py"]) == 0 and cli(["lib.py"]) == 0
    (tmp_path / DEFAULT_BASELINE).unlink()
    assert ref_cli(["lib.py", "--write-baseline"]) == 0
    assert cli(["lib.py"]) == 0
    assert cli(["lib.py", "--no-baseline"]) == 1
    data = json.loads((tmp_path / DEFAULT_BASELINE).read_text())
    assert data["version"] == 1 and len(data["suppressed"]) == 1
    capsys.readouterr()


def test_cli_list_rules_equal_the_reference(capsys):
    assert ref_cli(["--list-rules"]) == 0
    want = capsys.readouterr().out
    assert cli(["--list-rules"]) == 0
    assert capsys.readouterr().out == want
    for rid in ("RNG001", "OBS001", "SHARD001", "RES001", "TIME001"):
        assert rid in want


def test_port_package_scans_clean():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("0 finding(s): 0 error(s), "
                                        "0 warning(s)")
