"""The Mamba block and the reduced jamba on the card against the same on
the CPU.

Marked ``cuda``: it skips where no CUDA device is present.  It imports
no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba_cuda.py

The block is plain torch (the reference has no kernel for it); this
holds the card's float32 arithmetic, TF32 off, to the CPU's at
1e-4 x (1 + |cpu|): ``mamba_apply`` with the scan per step and in
checkpointed chunks, at init decays and at dt ~ 0.2 (decays down to
exp(-3.2) a step), outputs and gradients; ``mamba_decode`` step by step;
and the reduced jamba's forward (its GQA layer through the
``flash_attention`` kernel on the card, its plain version on the CPU).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

TOL = 1e-4
NAME = "jamba-1.5-large-398b"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this test compares the card with "
                    "the CPU)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _close(got, want, what=""):
    err = (got.cpu().float() - want.float()).abs()
    assert bool((err <= TOL * (1 + want.float().abs())).all()), (
        what, float(err.max()))


def _layer(cfg, dt):
    """The Mamba layer's params on the CPU; ``dt`` None keeps the init's
    dt ~ 0.01, else the dt bias puts softplus(...) near ``dt``."""
    p = L.mamba_init(cfg, L.Init(0, torch.device("cpu")))
    if dt is not None:
        p["dt_bias"].fill_(math.log(math.expm1(dt)))
    return p


def _run(p, x, dout, cfg, device):
    leaves = {k: v.to(device).requires_grad_() for k, v in p.items()}
    xd = x.to(device).requires_grad_()
    out = L.mamba_apply(leaves, xd, cfg)
    torch.sum(out * dout.to(device)).backward()
    return out.detach(), xd.grad, {k: v.grad for k, v in leaves.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [0, 64])
@pytest.mark.parametrize("dt", [None, 0.2])
def test_mamba_apply_card_matches_cpu(cuda_device, chunk, dt):
    cfg = dataclasses.replace(get_config(NAME).reduced(),
                              mamba_scan_chunk=chunk)
    p = _layer(cfg, dt)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 128, cfg.d_model)).astype(
        np.float32))
    dout = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    got = _run(p, x, dout, cfg, cuda_device)
    want = _run(p, x, dout, cfg, torch.device("cpu"))
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "dx")
    for key in p:
        _close(got[2][key], want[2][key], key)


@pytest.mark.cuda
def test_mamba_decode_card_matches_cpu(cuda_device):
    cfg = get_config(NAME).reduced()
    p = _layer(cfg, 0.2)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    cpu = torch.device("cpu")
    caches = {dev: L.mamba_init_cache(cfg, 2, torch.float32, dev)
              for dev in (cuda_device, cpu)}
    params = {dev: {k: v.to(dev) for k, v in p.items()} for dev in caches}
    with torch.no_grad():
        for t in range(16):
            outs = {}
            for dev in caches:
                outs[dev], caches[dev] = L.mamba_decode(
                    params[dev], x[:, t:t + 1].to(dev), caches[dev], cfg)
            _close(outs[cuda_device], outs[cpu], f"step {t}")
    for key in ("h", "conv"):
        _close(caches[cuda_device][key], caches[cpu][key], key)


@pytest.mark.cuda
def test_reduced_jamba_forward_card_matches_cpu(cuda_device):
    """One 8-layer block (1 GQA + 7 Mamba layers, dense and MoE FFNs)
    over 128 positions: hidden states and the aux loss."""
    cfg = get_config(NAME).reduced()
    params = T.init_params(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 128)))
    with torch.no_grad():
        want, want_aux = T.forward(params, cfg, x)
        got, aux = T.forward(tree_map(lambda t: t.to(cuda_device), params),
                             cfg, x.to(cuda_device))
    _close(got, want, "h")
    _close(aux, want_aux, "aux")
