"""The port's runtime contracts, in PyTorch's semantics: a counterpart of
each test of tests/test_contracts.py, plus the guard's wiring.

``no_recompile`` counts programs built inside a block: kernel libraries
compiled or first loaded (``kernels/build.py``) and ``torch.compile``
graphs (dynamo's count), so it is always enforced.  ``assert_donated``
reads version counters: the port's counterpart of a donated buffer is a
tensor written in place.  ``nan_tripwire`` raises at the op that made
the first non-finite value.  ``FLConfig(guard_recompiles=True)`` runs
every warm cohort round under ``no_recompile`` and changes no value.
"""
import contextlib
import stat
import sys
import warnings

import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.configs import InputShape, get_config
from repro_torch.fl import cohort_engine
from repro_torch.fl.rounds import FLConfig, RegionTrainer
from repro_torch.kernels import build
from repro_torch.launch.train import make_sharded_train_step
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves

FL = dict(dataset="mnist", n_rounds=3, train_fraction=0.005, n_devices=4,
          n_air=1, h_local=2, eval_size=64, seed=3, execution="batched",
          device="cpu")


@pytest.fixture(scope="module")
def doubler():
    f = torch.compile(lambda x: x * 2, backend="eager")
    f(torch.ones(3))          # warm one shape
    return f


def _guarded_rounds(monkeypatch, cfg):
    """Step a trainer for ``cfg.n_rounds`` rounds, recording every
    ``no_recompile`` block the cohort engine opens: (label, count,
    enforced).  Returns the records and the final params."""
    seen = []
    real = contracts.no_recompile

    @contextlib.contextmanager
    def spy(*args, **kw):
        with real(*args, **kw) as rc:
            yield rc
        seen.append((kw.get("label"), rc.count, rc.enforced))

    monkeypatch.setattr(cohort_engine.contracts, "no_recompile", spy)
    trainer = RegionTrainer(cfg)
    for r in range(cfg.n_rounds):
        trainer.step(r)
    return seen, tree_leaves(trainer.params)


# ---------------------------------------------------------------------------
# no_recompile
# ---------------------------------------------------------------------------
def test_no_recompile_clean(monkeypatch):
    """Every warm round of a guarded ``CohortEngine`` runs under the
    contract with count 0 (rounds 2 and 3 repeat round 1's buckets)."""
    seen, _ = _guarded_rounds(monkeypatch,
                              FLConfig(guard_recompiles=True, **FL))
    assert len(seen) >= 1
    assert all(s == ("CohortEngine.round", 0, True) for s in seen), seen


def test_no_recompile_violation_names_label(doubler):
    with contracts.no_recompile() as probe:
        pass
    assert probe.enforced
    with pytest.raises(contracts.ContractViolation, match="warm path"):
        with contracts.no_recompile(label="warm path"):
            doubler(torch.ones(17))          # fresh shape -> new graph


def test_no_recompile_allow_budget(doubler):
    with contracts.no_recompile(allow=8) as rc:
        doubler(torch.ones(23, 2))
    assert 0 < rc.count <= 8
    with contracts.no_recompile() as rc:
        doubler(torch.ones(23, 2))           # now warm
    assert rc.count == 0


def test_no_recompile_counts_a_kernel_build(tmp_path, monkeypatch):
    """A library compiled into a fresh build root counts, so the contract
    is enforced without dynamo: here nvcc is a stand-in that writes the
    library it is asked for."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'lib')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    (tmp_path / "csrc").mkdir()
    source = tmp_path / "csrc" / "k.cu"
    source.write_text("// kernel\n")
    with pytest.raises(contracts.ContractViolation, match="cold build"):
        with contracts.no_recompile(label="cold build"):
            build.compile_library(source, root=tmp_path / "root")
    with contracts.no_recompile() as rc:     # built: nvcc does not run
        lib = build.compile_library(source, root=tmp_path / "root")
    assert rc.count == 0 and lib.read_bytes() == b"lib"


def test_contract_violation_is_assertion_error():
    assert issubclass(contracts.ContractViolation, AssertionError)


# ---------------------------------------------------------------------------
# assert_donated: the port's donation is the in-place write
# ---------------------------------------------------------------------------
def _train_step(donate):
    cfg = get_config("llama3.2-3b").reduced()
    shape = InputShape("tiny", 16, 2, "train")
    step = make_sharded_train_step(cfg, shape, lr=0.01, donate=donate,
                                   device="cpu")
    params = T.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
             for k in ("inputs", "labels")}
    return step, params, batch


def test_assert_donated_pass():
    step, params, batch = _train_step(donate=True)
    with contracts.assert_donated(params, label="train step"):
        out, _ = step(params, batch)
    assert out is params


def test_assert_donated_strict_raises_when_not_donated():
    step, params, batch = _train_step(donate=False)
    with pytest.raises(contracts.ContractViolation, match="still live"):
        with contracts.assert_donated(params, label="train step"):
            step(params, batch)


def test_assert_donated_strict_on_every_device():
    """The reference warns on the CPU, where jax's donation is a no-op; an
    in-place write is the same on every device, so the port raises there
    too unless asked to warn (``strict=False``)."""
    x = torch.ones(4)
    with pytest.raises(contracts.ContractViolation, match="cpu"):
        with contracts.assert_donated(x):
            pass
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with contracts.assert_donated(x, strict=False):
            pass
    assert len(w) == 1 and issubclass(w[0].category, RuntimeWarning)


def test_assert_donated_watches_pytrees():
    tree = {"w": torch.ones(3), "b": [torch.zeros(2)]}
    with contracts.assert_donated(tree, strict=True):
        tree["w"].mul_(2)
        tree["b"][0][1:].add_(1)             # a view's write counts
    with pytest.raises(contracts.ContractViolation, match="1/2"):
        with contracts.assert_donated(tree, label="half"):
            tree["w"].add_(1)


# ---------------------------------------------------------------------------
# nan_tripwire / assert_finite
# ---------------------------------------------------------------------------
def test_nan_tripwire_raises_and_restores():
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    with pytest.raises(contracts.ContractViolation, match="aten.log"):
        with contracts.nan_tripwire():
            torch.log(torch.zeros(2) - 1.0)
    after = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    assert before == after
    torch.log(torch.zeros(2) - 1.0)          # the mode is gone
    # backward: the op that makes the first inf gradient is named
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(contracts.ContractViolation, match="aten.div"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with contracts.nan_tripwire():
                torch.sqrt(w - 1.0).sum().backward()
    # a kernel's output, written behind the dispatcher's back, is named
    # by its dispatcher's check; unarmed, the check does nothing
    bad = torch.tensor([1.0, float("nan")])
    contracts.check_kernel_outputs("flash_attention", bad)
    with pytest.raises(contracts.ContractViolation,
                       match="kernel flash_attention"):
        with contracts.nan_tripwire():
            contracts.check_kernel_outputs("flash_attention", bad)


def test_nan_tripwire_clean_block():
    with contracts.nan_tripwire():
        out = torch.log(torch.ones(2))
    assert bool(torch.isfinite(out).all())
    with pytest.raises(contracts.ContractViolation, match="NaN/inf"):
        with contracts.nan_tripwire():
            torch.full((2,), float("inf"))
    with contracts.nan_tripwire(infs=False):
        inf = torch.full((2,), float("inf"))
    assert bool(torch.isinf(inf).all())


def test_assert_finite():
    contracts.assert_finite({"w": torch.ones(3)})
    with pytest.raises(contracts.ContractViolation,
                       match=r"\[merge input\]: 1 leaf"):
        contracts.assert_finite({"w": torch.tensor([1.0, float("nan")]),
                                 "b": torch.ones(2)},
                                label="merge input")
    # integer leaves are ignored (no float finiteness to check)
    contracts.assert_finite({"counts": torch.arange(4)})


# ---------------------------------------------------------------------------
# FLConfig.guard_recompiles
# ---------------------------------------------------------------------------
def test_guarded_run_equals_unguarded_bit_for_bit(monkeypatch):
    seen, guarded = _guarded_rounds(monkeypatch,
                                    FLConfig(guard_recompiles=True, **FL))
    assert seen
    off, plain = _guarded_rounds(monkeypatch,
                                 FLConfig(guard_recompiles=False, **FL))
    assert off == []
    assert len(guarded) == len(plain)
    assert all(torch.equal(a, b) for a, b in zip(guarded, plain))
