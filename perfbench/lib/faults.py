"""Faults planted under a run's timed path, for the comparison's own
check: each must turn ``correct`` false.

``plant(driver, fault)`` patches the program for the block:

- ``unchanged``: the step returns its state unchanged (the local
  updates run; the global model does not take them);
- ``half_batch``: every local step sees half of its rows, the mean taken
  over the rest;
- ``answer_altered``: the aggregate's answer is altered where it is
  made: in the SAGIN round its largest leaf is the first client's
  model, not the mean; in the FL step the mean is written into every replica's
  slot but the last, which keeps its own local model.

One card holds each cell, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(module, name, new):
    old = getattr(module, name)
    setattr(module, name, new)
    try:
        yield old
    finally:
        setattr(module, name, old)


def _half_mask(mask: torch.Tensor) -> torch.Tensor:
    """Each (client, step)'s real samples cut to the first half."""
    n = mask.sum(dim=-1, keepdim=True)
    slot = torch.arange(mask.shape[-1], device=mask.device)
    return mask * (slot < torch.ceil(n / 2)).to(mask.dtype)


@contextlib.contextmanager
def _sagin(fault: str):
    from repro_torch.fl import cohort_engine as E
    from repro_torch.fl import rounds as Rn
    if fault == "unchanged":
        real = Rn._round_batched

        def frozen(cfg, apply_fn, params, *args, **kw):
            _, losses, n = real(cfg, apply_fn, params, *args, **kw)
            return params, losses, n

        with _patched(Rn, "_round_batched", frozen):
            yield
    elif fault == "half_batch":
        real = E.cohort_local_update

        def half(apply_fn, params, xs, ys, mask, lr):
            return real(apply_fn, params, xs, ys, _half_mask(mask), lr)

        with _patched(E, "cohort_local_update", half):
            yield
    elif fault == "answer_altered":
        real = E.fedavg_stacked_multi

        def first_client(parts, weights):
            from repro_torch.tree import tree_leaves, tree_map
            out = real(parts, weights)
            sizes = [x.numel() for x in tree_leaves(out)]
            big = sizes.index(max(sizes))
            first = tree_leaves(parts[0])[big][0]
            it = iter(range(len(sizes)))
            return tree_map(lambda x: first.clone() if next(it) == big
                            else x, out)

        with _patched(E, "fedavg_stacked_multi", first_client):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}")


@contextlib.contextmanager
def _fl_step(fault: str):
    from repro_torch.launch import train as T
    if fault in ("unchanged", "half_batch"):
        real = T._donated_step

        def make(cfg, lr, dev):
            step = real(cfg, lr, dev)
            if fault == "half_batch":
                def half(params, batch):
                    n = batch["inputs"].shape[0]
                    return step(params, {k: batch[k][:max(1, n // 2)]
                                         for k in ("inputs", "labels")})
                return half
            ghost = real(cfg, 0.0, dev)     # the loss, without an update
            return ghost

        with _patched(T, "_donated_step", make):
            yield
    elif fault == "answer_altered":
        real = T.fedavg_stacked

        def all_but_last(stacked, weights):
            # the mean broadcast into slots 0..n-2; the last slot's own
            # model in place of the mean there
            from repro_torch.tree import tree_map
            agg = real(stacked, weights)
            return tree_map(lambda a, s: torch.cat(
                [a.unsqueeze(0).expand(s.shape[0] - 1, *a.shape),
                 s[-1:].to(a.dtype)]), agg, stacked)

        with _patched(T, "fedavg_stacked", all_but_last):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}")


PLANTERS = {"sagin_round": _sagin, "fl_step": _fl_step}


def plant(driver: str, fault: str):
    """The context in which ``driver``'s program carries ``fault``."""
    return PLANTERS[driver](fault)
