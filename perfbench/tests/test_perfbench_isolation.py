"""Nothing the benchmark runs imports JAX or the JAX package, the plain
references import nothing of the program, and nothing reads the JAX
package's benchmarks.  Top-level module names are compared whole: the
port's name, ``repro_torch``, begins with the JAX package's."""
import ast
import subprocess
import sys

import pytest

from perfbench.lib import harness

FILES = sorted(harness.BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module ``path`` imports (relative imports
    stay inside the benchmark)."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.parts],
    ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def strings(path):
    """The string constants of ``path``'s code, docstrings left out."""
    tree = ast.parse(path.read_text(), str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and \
                isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.name != "test_perfbench_isolation.py"],
    ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_nothing_reads_the_jax_benchmarks(path):
    for text in strings(path):
        assert "benchmarks" not in text and "BENCH_" not in text
        assert "chip_smoke" not in text


def test_a_run_loads_no_jax():
    """The harness, every driver and every reader imported in a fresh
    process, with the program's modules they pull in: no JAX there."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench.lib import harness\n"
        "b = harness.benchmark()\n"
        "for c in b['workloads']:\n"
        "    ctx = harness.context(c['name'], 1, device='cpu')\n"
        "    harness.driver(ctx)\n"
        "for m in b['per_layer']:\n"
        "    harness.load_module(harness.BENCH / 'metrics' / (m['name'] + '.py'), m['name'])\n"
        "import repro_torch.fl.rounds, repro_torch.launch.train\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(harness.ROOT), str(harness.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
