"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py``, on the CPU at tiny arguments.

Both examples run from the same command line (``sys.argv``) and, where
they train, from the same initial model: the reference's, carried over
with ``convert.params_from_jax`` / ``transformer_params_from_jax``.  The
control plane is one code in both packages, so plan latencies, cases,
placements, training times and merge fields print identically;
accuracies agree within 4/eval_size (plus the printed rounding).  The
model demos: the loss after 3 steps within 1e-4 x (1 + |loss|) and the
decoded tokens equal, for one config of each family (dense GQA, RWKV6,
MoE with MLA, embeddings input), and ``serve_demo``'s sequences equal.

The reference's model demos call ``init_params`` eagerly, which leaves
JAX (0.9) retracing later eager calls of the process (tests that count
recompiles then fail); they run in one subprocess, started with the
module's first test so that it overlaps the FL cases, which hands back
their printed lines, initial params and last-step loss.
"""
import importlib.util
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.fl import FLConfig as JaxFLConfig
from repro.models import cnn as jax_cnn
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, transformer_params_from_jax
from repro_torch.examples import (multiarch_demo, offloading_walkthrough,
                                  quickstart, sagin_fl_end2end, serve_demo)
from repro_torch.fl import FLConfig

ROOT = Path(__file__).resolve().parents[1]
MODEL_ARCHS = ["llama3.2-3b", "rwkv6-1.6b", "deepseek-v2-lite-16b",
               "internvl2-1b"]
SERVE_ARGV = ["--arch", "llama3.2-3b", "--batch", "2", "--prompt-len", "8",
              "--gen", "12"]
FL_ARGV = ["--rounds", "1", "--devices", "4", "--air", "1", "--fraction",
           "0.005"]
EVAL_SIZE = 1024      # sagin_fl_end2end's own
ACC_TOL = 4 / EVAL_SIZE + 5e-4   # plus the printed rounding
LOSS_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's many small CPU ops: as fast
    alone, and beside the suite's other workers it keeps torch's thread
    pool from oversubscribing the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(monkeypatch, capsys, main, argv, **kw):
    """``main`` under ``sys.argv = argv``; its return value and printed
    lines."""
    monkeypatch.setattr(sys, "argv", ["example", *argv])
    capsys.readouterr()
    out = main(**kw)
    return out, capsys.readouterr().out.splitlines()


@pytest.fixture(scope="module")
def mnist_init():
    """The reference's initial MNIST model at seed 0, in the port's
    layout on the CPU."""
    params, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(0),
                                    image_shape=(28, 28, 1))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                           "cpu")


def _split_floats(line, keys):
    """``line`` with the numbers after each of ``keys`` cut out, and
    those numbers."""
    nums = []
    for key in keys:
        m = re.search(re.escape(key) + r"\s*(-?\d+\.\d+)", line)
        nums.append(float(m.group(1)))
        line = line[:m.start(1)] + "#" + line[m.end(1):]
    return line, nums


def _same_lines(got, want, acc_keys):
    """Every line equal, but the accuracies after ``acc_keys``, which
    agree within ``ACC_TOL``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        keys = [k for k in acc_keys if k in w]
        g_rest, g_acc = _split_floats(g, keys)
        w_rest, w_acc = _split_floats(w, keys)
        assert g_rest == w_rest
        np.testing.assert_allclose(g_acc, w_acc, atol=ACC_TOL)


@pytest.fixture(scope="module", autouse=True)
def model_demos(tmp_path_factory):
    """The reference's ``multiarch_demo`` for ``MODEL_ARCHS`` and
    ``serve_demo`` at ``SERVE_ARGV``, in one subprocess started with the
    module's first test, so that it runs beside the FL cases; call it
    for the results: per run, the printed lines, the initial params as
    numpy and (multiarch) the last step's loss."""
    out = tmp_path_factory.mktemp("demos") / "demos.pkl"
    code = textwrap.dedent(f"""
        import importlib.util, pickle, sys, types
        import jax, numpy as np

        def load(name):
            spec = importlib.util.spec_from_file_location(
                name, {str(ROOT / "examples")!r} + "/" + name + ".py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod

        seen = {{}}

        def recording(mod):
            # the module's jax and transformer with jit and init_params
            # recording what they gave; init_params, init_cache and
            # serve_step jitted (eager, each op compiles on its own)
            def jit(fn, *a, **kw):
                compiled = jax.jit(fn, *a, **kw)
                def run(*x, **y):
                    seen["out"] = compiled(*x, **y)
                    return seen["out"]
                return run
            t = mod.T
            init = jax.jit(t.init_params, static_argnums=0)
            def init_params(*a):
                seen["params"] = init(*a)
                return seen["params"]
            mod.jax = types.SimpleNamespace(jit=jit, random=jax.random)
            mod.T = types.SimpleNamespace(**{{
                k: getattr(t, k) for k in dir(t) if not k.startswith("__")}})
            mod.T.init_params = init_params
            mod.T.init_cache = jax.jit(t.init_cache, static_argnums=(0, 1, 2))
            mod.T.serve_step = jax.jit(t.serve_step, static_argnums=1)
            return mod

        def params():
            return jax.tree_util.tree_map(np.asarray, seen["params"])

        results = {{}}
        multi = recording(load("multiarch_demo"))
        for arch in {MODEL_ARCHS!r}:
            multi.run(arch)
            results[arch] = {{"params": params(),
                              "loss": float(seen["out"][1]["loss"])}}
        serve = recording(load("serve_demo"))
        sys.argv = ["serve_demo", *{SERVE_ARGV!r}]
        print("--- serve_demo", flush=True)
        serve.main()
        results["serve_demo"] = {{"params": params()}}
        with open({str(out)!r}, "wb") as f:
            pickle.dump(results, f)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=ROOT)
    done = {}

    def results():
        if not done:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-4000:]
            with open(out, "rb") as f:
                done.update(pickle.load(f))
            multi, _, serve = stdout.partition("--- serve_demo\n")
            done["multi_lines"] = multi.splitlines()
            done["serve_demo"]["lines"] = serve.splitlines()
        return done

    yield results
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("name", ["quickstart", "offloading_walkthrough",
                                  "sagin_fl_end2end", "multiarch_demo",
                                  "serve_demo"])
def test_example_raises_without_a_card_at_its_default(name, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is there")
    mod = {"quickstart": quickstart,
           "offloading_walkthrough": offloading_walkthrough,
           "sagin_fl_end2end": sagin_fl_end2end,
           "multiarch_demo": multiarch_demo,
           "serve_demo": serve_demo}[name]
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main()


def test_offloading_walkthrough_matches_reference(monkeypatch, capsys):
    _, want = _run(monkeypatch, capsys, _reference(
        "offloading_walkthrough").main, [])
    out, got = _run(monkeypatch, capsys, offloading_walkthrough.main,
                    ["--device", "cpu"])
    assert got == want
    assert out["lines"] == got


def test_quickstart_matches_reference(monkeypatch, capsys, mnist_init):
    """The plan, then the FL run cut to a tiny size the same way in both
    examples (quickstart has no flags)."""
    tiny = dict(n_rounds=2, n_devices=4, n_air=1, train_fraction=0.005,
                eval_size=128, h_local=1)
    ref = _reference("quickstart")
    monkeypatch.setattr(ref, "FLConfig",
                        lambda **kw: JaxFLConfig(**{**kw, **tiny}))
    monkeypatch.setattr(quickstart, "FLConfig",
                        lambda **kw: FLConfig(**{**kw, **tiny}))
    _, want = _run(monkeypatch, capsys, ref.main, [])
    out, got = _run(monkeypatch, capsys, quickstart.main,
                    ["--device", "cpu"], params=mnist_init)
    assert out["lines"] == got
    assert out["result"].config.device == "cpu"
    assert len(got) == len(want) == 7
    assert got[:5] == want[:5]         # plan, case, speed-up, placement
    for g, w in zip(got[5:], want[5:]):
        g_rest, g_acc = _split_floats(g, ["accuracy"])
        w_rest, w_acc = _split_floats(w, ["accuracy"])
        assert g_rest == w_rest        # training times
        assert abs(g_acc[0] - w_acc[0]) <= 4 / 128 + 5e-4


def test_sagin_fl_end2end_adaptive_vs_none_matches_reference(
        monkeypatch, capsys, mnist_init):
    _, want = _run(monkeypatch, capsys, _reference("sagin_fl_end2end").main,
                   FL_ARGV)
    out, got = _run(monkeypatch, capsys, sagin_fl_end2end.main,
                    [*FL_ARGV, "--device", "cpu"], params=mnist_init)
    assert out["lines"] == got
    assert sorted(out["results"]) == ["adaptive", "none"]
    assert "cases used" in got[1] and "[          none]" in got[2]
    _same_lines(got, want, ["best acc"])


def test_sagin_fl_end2end_global_model_matches_reference(
        monkeypatch, capsys, mnist_init):
    argv = [*FL_ARGV, "--scenario", "multi_region", "--global-model",
            "--merge-every", "1", "--policy", "partial"]
    _, want = _run(monkeypatch, capsys, _reference("sagin_fl_end2end").main,
                   argv)
    out, got = _run(monkeypatch, capsys, sagin_fl_end2end.main,
                    [*argv, "--device", "cpu"], params=mnist_init)
    assert out["lines"] == got
    assert len(out["merges"]) == 1
    assert all(m.policy == "partial" for m in out["merges"])
    assert len(got) == 4 + 1
    _same_lines(got, want, ["best acc", "global acc"])


def test_sagin_fl_end2end_lists_scenarios(monkeypatch, capsys):
    _, want = _run(monkeypatch, capsys, _reference("sagin_fl_end2end").main,
                   ["--list-scenarios"])
    out, got = _run(monkeypatch, capsys, sagin_fl_end2end.main,
                    ["--list-scenarios"])
    assert got == want == out["lines"]


def _decoded(line):
    """The tokens of a ``decoded=[...]`` field, as the reference prints
    them (0-d arrays) or as the port does (ints)."""
    field = re.search(r"decoded=\[(.*?)\] \[", line).group(1)
    return [int(x) for x in re.findall(r"(?:array\()?(-?\d+)(?:, dtype=\w+\))?",
                                       field)]


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_multiarch_demo_matches_reference(arch, model_demos, monkeypatch,
                                          capsys):
    ref = model_demos()
    want_line = next(ln for ln in ref["multi_lines"] if ln.startswith(arch))
    params = transformer_params_from_jax(
        get_config(arch).reduced(), ref[arch]["params"], "cpu")
    out, got = _run(monkeypatch, capsys, multiarch_demo.main,
                    ["--arch", arch, "--device", "cpu"], params=params)
    (run,) = out["runs"]
    want_loss = ref[arch]["loss"]
    assert abs(run["loss"] - want_loss) <= LOSS_TOL * (1 + abs(want_loss))
    assert run["decoded"] == _decoded(want_line) == _decoded(got[0])
    # the fields of the line but the wall time
    strip = re.compile(r"\(\d+\.\d+s\)$")
    assert strip.sub("", got[0]).split(" decoded=")[0] == \
        strip.sub("", want_line).split(" decoded=")[0]
    assert got[0].split("] [full:")[1].split("(")[0] == \
        want_line.split("] [full:")[1].split("(")[0]


def test_multiarch_demo_needs_arch_for_params():
    cfg = get_config("llama3.2-3b").reduced()
    from repro_torch.models import transformer as T
    with pytest.raises(ValueError, match="--arch"):
        multiarch_demo.main(["--device", "cpu"],
                            params=T.init_params(cfg, device="cpu"))


def test_serve_demo_matches_reference(model_demos, monkeypatch, capsys):
    ref = model_demos()["serve_demo"]
    cfg = get_config("llama3.2-3b").reduced()
    assert jax_get_config("llama3.2-3b").reduced().n_layers == cfg.n_layers
    out, got = _run(monkeypatch, capsys, serve_demo.main,
                    [*SERVE_ARGV, "--device", "cpu"],
                    params=transformer_params_from_jax(cfg, ref["params"],
                                                       "cpu"))
    want = ref["lines"]
    i = want.index("sequences:")
    assert got[i + 1:] == want[i + 1:]
    assert out["sequences"] == [json.loads(ln) for ln in want[i + 1:]]
    assert len(out["sequences"]) == 2 and len(out["sequences"][0]) == 12
    assert got[0].startswith("[llama3.2-3b] prefilled 8 tokens in ")
    assert got[1].endswith("tok/s on CPU)")
