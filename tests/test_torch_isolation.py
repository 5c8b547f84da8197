"""The port stands alone: no module of ``repro_torch`` and no line of
``chip_smoke.py`` imports JAX or the reference package ``repro``."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.fl.rounds" in mods
    assert "repro_torch.kernels.fedavg_agg.kernel" in mods
    for name in ("kernels.flash_attention.kernel", "kernels.wkv6.kernel",
                 "models.layers", "models.transformer", "configs.registry",
                 "launch.train", "launch.serve", "serve.backends",
                 "sim.propagation", "sim.dynamics", "sim.engine",
                 "scenarios.registry", "resilience.faults",
                 "serve.workload", "fl.federation.base",
                 "fl.federation.policies", "fl.baselines",
                 "serve.router", "serve.gateway", "serve.__main__",
                 "obs.report", "obs.__main__", "checkpoint.ckpt",
                 "checkpoint.engine", "optim.sgd", "optim.adam",
                 "optim.api", "analysis.contracts", "analysis.rules",
                 "analysis.__main__", "configs.paper_cnn", "launch.mesh",
                 "launch.op_analysis", "launch.dryrun", "kernels.region"):
        assert f"repro_torch.{name}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_resolve_device_raises_without_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
