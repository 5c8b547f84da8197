"""MLA and the MoE FFN on the card against the same on the CPU.

Marked ``cuda``: it skips where no CUDA device is present.  It imports
no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_mla_cuda.py

Both layers are plain torch (the reference has no kernel for them); this
holds the card's dispatch (``topk``, the stable ``argsort``, gathers and
the flat path's ``index_add``) and its float32 arithmetic, TF32 off, to
the CPU's at 1e-4 x (1 + |cpu|), outputs and gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this test compares the card with "
                    "the CPU)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _run(fn, params, x, dout, device):
    """``fn(params, x)`` on ``device`` and the gradients of
    ``sum(out * dout)`` with respect to ``x`` and every leaf."""
    leaves = {k: v.to(device).requires_grad_() for k, v in params.items()}
    xd = x.to(device).requires_grad_()
    out = fn(leaves, xd)
    torch.sum(out * dout.to(device)).backward()
    grads = {k: v.grad.cpu() for k, v in leaves.items()}
    return out.detach().cpu(), xd.grad.cpu(), grads


def _flat(p):
    """The MoE params without the nested shared expert (its leaves under
    ``shared/``), so that each leaf is a tensor."""
    out = {k: v for k, v in p.items() if k != "shared"}
    out.update({f"shared/{k}": v for k, v in p.get("shared", {}).items()})
    return out


def _nest(p):
    out = {k: v for k, v in p.items() if not k.startswith("shared/")}
    shared = {k[len("shared/"):]: v for k, v in p.items()
              if k.startswith("shared/")}
    if shared:
        out["shared"] = shared
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name,grouped", [
    ("deepseek-v2-lite-16b", True), ("deepseek-v2-lite-16b", False),
    ("qwen3-moe-235b-a22b", True), ("qwen3-moe-235b-a22b", False)])
def test_moe_apply_card_matches_cpu(cuda_device, name, grouped):
    cfg = dataclasses.replace(get_config(name).reduced(n_experts=16),
                              moe_grouped=grouped)
    cpu = torch.device("cpu")
    params = _flat(L.moe_init(cfg, L.Init(0, cpu)))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 64, cfg.d_model)).astype(
        np.float32))
    dout = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))

    def fn(p, xx):
        return L.moe_apply(_nest(p), xx, cfg)

    got = _run(fn, params, x, dout, cuda_device)
    want = _run(fn, params, x, dout, cpu)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for key in want[2]:
        np.testing.assert_allclose(got[2][key].numpy(),
                                   want[2][key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)


@pytest.mark.cuda
def test_mla_apply_card_matches_cpu(cuda_device):
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    cpu = torch.device("cpu")
    params = L.mla_init(cfg, L.Init(0, cpu))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 128, cfg.d_model)).astype(
        np.float32))
    dout = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))

    def fn(p, xx):
        pos = torch.arange(xx.shape[1], dtype=torch.int32, device=xx.device)
        return L.mla_apply(p, xx, cfg, pos)

    got = _run(fn, params, x, dout, cuda_device)
    want = _run(fn, params, x, dout, cpu)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for key in want[2]:
        np.testing.assert_allclose(got[2][key].numpy(),
                                   want[2][key].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
