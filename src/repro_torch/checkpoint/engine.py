"""Full-engine checkpoint/resume for :class:`~repro_torch.sim.engine.SAGINEngine`.

Snapshots EVERYTHING the event-stepped FL run needs to continue
bit-identically: per-region model params, both RNG stream states (the
trainer's batch-draw generator and the orchestrator's satellite-CPU
generator), the Gilbert-Elliott dynamics chain states, wall clocks,
index pools, accumulated :class:`~repro_torch.fl.rounds.FLResult`
curves, the engine's merge history, the global model, and the fault
injector's counters — such that at equal seeds

    engine.run(10)

and

    engine.run(5, final_merge=False)
    save_engine(engine, dir)
    ...                               # new process, fresh engine
    restore_engine(engine2, dir)
    engine2.run(5)

produce identical result curves, merges, and global params
(``tests/test_torch_checkpoint.py``).  Every random draw of a run comes
from those NumPy generators: the port's trainers, cohort engines and
engine hold no ``torch.Generator`` (the model init draws from one that
lives only inside ``build_model``), so there is no torch RNG state to
carry.

A checkpoint is a DIRECTORY, in the JAX package's format (manifest
version 1, kind ``sagin-engine``):

* ``manifest.json``        — versioned run state (everything JSON-
  serializable), written atomically (temp file + ``os.replace``, the
  :mod:`repro_torch.checkpoint.ckpt` discipline) and LAST, so a
  manifest's existence certifies a complete checkpoint.
* ``region<i>_params.npz`` (+ ``.tree`` sidecar) — per-region models.
* ``global_params.npz``    — the merged global model, when one exists.

Params are written in the reference's layout (HWIO conv kernels,
:func:`repro_torch.convert.params_to_numpy`) and read back through
:func:`repro_torch.convert.params_from_jax` onto each trainer's device,
so a checkpoint written by either package restores into the other, and
one written on the card restores on the CPU.

``restore_engine`` restores INTO a freshly constructed engine built
with the same scenario/config/seed: construction replays the identical
derivation draws (dataset, partition, eval-set choice, model init), and
the checkpoint then overwrites every piece of state that advanced.
What is deliberately NOT checkpointed: cohort-engine bucket
signatures/stats and per-round
:class:`~repro_torch.core.scheduler.RoundRecord` histories (derived
telemetry; the result curves carry the trajectory).  The ``static``
offload strategy caches its round-0 plan outside the snapshot, so
resume it from round 0 only.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ..convert import params_from_jax, params_to_numpy
from .ckpt import _atomic_write_bytes, load_pytree, save_pytree

MANIFEST_VERSION = 1
MANIFEST_KIND = "sagin-engine"


def _pools_state(pools) -> dict:
    return {
        "ground": [p.tolist() for p in pools.ground],
        "ground_sensitive": [p.tolist() for p in pools.ground_sensitive],
        "air": [p.tolist() for p in pools.air],
        "sat": pools.sat.tolist(),
    }


def _restore_pools(pools, state: dict) -> None:
    pools.ground = [np.asarray(p, dtype=np.int64)
                    for p in state["ground"]]
    pools.ground_sensitive = [np.asarray(p, dtype=np.int64)
                              for p in state["ground_sensitive"]]
    pools.air = [np.asarray(p, dtype=np.int64) for p in state["air"]]
    pools.sat = np.asarray(state["sat"], dtype=np.int64)


def _result_state(res) -> dict:
    return {
        "times": list(res.times),
        "accuracies": list(res.accuracies),
        "losses": list(res.losses),
        "latencies": list(res.latencies),
        "cases": list(res.cases),
        "layer_portions": list(res.layer_portions),
        "participated": list(res.participated),
    }


def _restore_result(res, state: dict) -> None:
    res.times[:] = [float(x) for x in state["times"]]
    res.accuracies[:] = [float(x) for x in state["accuracies"]]
    res.losses[:] = [float(x) for x in state["losses"]]
    res.latencies[:] = [float(x) for x in state["latencies"]]
    res.cases[:] = [int(x) for x in state["cases"]]
    res.layer_portions[:] = [dict(p) for p in state["layer_portions"]]
    res.participated[:] = [bool(x) for x in state["participated"]]


def _trainer_state(trainer) -> dict:
    orch = trainer.orch
    return {
        "rng": trainer.rng.bit_generator.state,
        "orch_rng": orch._rng.bit_generator.state,
        "wall_clock": float(orch.wall_clock),
        "dynamics": (orch.dynamics.state_dict()
                     if orch.dynamics is not None else None),
        "last_isl_scale": float(trainer._last_isl_scale),
        "result": _result_state(trainer.result),
        "pools": _pools_state(trainer.pools),
    }


def _load_params(trainer, path: str):
    """A params file (reference layout) as a tree in the port's layout
    on ``trainer``'s device, shaped like the trainer's model."""
    template = params_to_numpy(trainer.params)
    return params_from_jax(load_pytree(template, path), trainer.device)


def _restore_trainer(trainer, state: dict, params_path: str) -> None:
    from ..fl.rounds import _sync_sizes

    trainer.params = _load_params(trainer, params_path)
    trainer.rng.bit_generator.state = state["rng"]
    orch = trainer.orch
    orch._rng.bit_generator.state = state["orch_rng"]
    orch.wall_clock = float(state["wall_clock"])
    if state["dynamics"] is not None:
        if orch.dynamics is None:
            raise ValueError(
                f"checkpoint carries dynamics state but the rebuilt "
                f"trainer for region {trainer._region_name!r} has none "
                f"— scenario mismatch?")
        orch.dynamics.load_state_dict(state["dynamics"])
    trainer._last_isl_scale = float(state["last_isl_scale"])
    _restore_result(trainer.result, state["result"])
    _restore_pools(trainer.pools, state["pools"])
    _sync_sizes(trainer.pools, trainer.sagin)


def _merge_state(m) -> dict:
    return {
        "barrier_round": m.barrier_round, "time": m.time,
        "staleness": list(m.staleness), "weights": list(m.weights),
        "isl_costs": list(m.isl_costs), "accuracies": list(m.accuracies),
        "policy": m.policy, "hub": m.hub,
        "participants": list(m.participants),
        "recipients": list(m.recipients),
    }


def _restore_merges(states: List[dict]):
    from ..sim.engine import MergeEvent
    return [MergeEvent(
        barrier_round=int(s["barrier_round"]), time=float(s["time"]),
        staleness=tuple(s["staleness"]), weights=tuple(s["weights"]),
        isl_costs=tuple(s["isl_costs"]),
        accuracies=tuple(s["accuracies"]), policy=s["policy"],
        hub=int(s["hub"]), participants=tuple(s["participants"]),
        recipients=tuple(s["recipients"])) for s in states]


def save_engine(engine, path: str) -> str:
    """Snapshot a (FL-mode) engine's full run state into directory
    ``path``.  Returns the manifest path.

    Safe against crashes mid-save: params land via the atomic npz
    writer, and the manifest — written last, atomically — is what
    :func:`restore_engine` keys on, so an interrupted save can never
    masquerade as a complete checkpoint (a previous manifest at the
    same path keeps describing the previous, still-intact snapshot
    only if its params files were not yet overwritten — use a fresh
    directory per snapshot when that matters).
    """
    if not engine.trainers:
        raise ValueError("save_engine snapshots FL-mode engines; this "
                         "engine has no region trainers")
    os.makedirs(path, exist_ok=True)
    regions = []
    for i, t in enumerate(engine.trainers):
        save_pytree(params_to_numpy(t.params),
                    os.path.join(path, f"region{i}_params.npz"))
        regions.append(_trainer_state(t))
    has_global = engine.global_params is not None
    if has_global:
        save_pytree(params_to_numpy(engine.global_params),
                    os.path.join(path, "global_params.npz"))
    manifest = {
        "version": MANIFEST_VERSION,
        "kind": MANIFEST_KIND,
        "scenario": engine.scenario.name,
        "n_regions": len(engine.trainers),
        "rounds_done": len(engine.trainers[0].result.times),
        "has_global": has_global,
        "merges": [_merge_state(m) for m in engine.merges],
        "faults": (engine.fault_injector.state_dict()
                   if engine.fault_injector is not None else None),
        "regions": regions,
    }
    manifest_path = os.path.join(path, "manifest.json")
    _atomic_write_bytes(manifest_path,
                        json.dumps(manifest, indent=1).encode("utf-8"))
    return manifest_path


def restore_engine(engine, path: str):
    """Restore the snapshot in directory ``path`` into ``engine`` — a
    freshly constructed engine with the same scenario/FLConfig/seed —
    and return it.  Raises :class:`ValueError` on a missing/foreign/
    mismatched checkpoint.  Emits one ``resume`` span on the engine's
    tracer (purely observational, like all obs)."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise ValueError(f"no engine checkpoint at {path!r} "
                         f"(manifest.json missing)")
    with open(manifest_path, "r", encoding="utf-8") as f:
        manifest = json.load(f)
    if manifest.get("kind") != MANIFEST_KIND:
        raise ValueError(f"{manifest_path} is not a sagin-engine "
                         f"checkpoint (kind={manifest.get('kind')!r})")
    if manifest.get("version") != MANIFEST_VERSION:
        raise ValueError(f"unsupported engine-checkpoint version "
                         f"{manifest.get('version')!r}; this build reads "
                         f"version {MANIFEST_VERSION}")
    if manifest["scenario"] != engine.scenario.name:
        raise ValueError(f"checkpoint is for scenario "
                         f"{manifest['scenario']!r}, engine runs "
                         f"{engine.scenario.name!r}")
    if manifest["n_regions"] != len(engine.trainers):
        raise ValueError(f"checkpoint has {manifest['n_regions']} "
                         f"regions, engine has {len(engine.trainers)}")
    for i, (t, state) in enumerate(zip(engine.trainers,
                                       manifest["regions"])):
        _restore_trainer(t, state,
                         os.path.join(path, f"region{i}_params.npz"))
    engine.merges = _restore_merges(manifest["merges"])
    if manifest["has_global"]:
        engine.global_params = _load_params(
            engine.trainers[0], os.path.join(path, "global_params.npz"))
    else:
        engine.global_params = None
    if manifest["faults"] is not None:
        if engine.fault_injector is None:
            raise ValueError("checkpoint carries fault-injector state "
                             "but the engine has no fault plan — "
                             "scenario mismatch?")
        engine.fault_injector.load_state_dict(manifest["faults"])
    tr = engine.tracer
    if tr.enabled:
        from ..obs import FEDERATION_TRACK
        tr.event("resume", f"resume@r{manifest['rounds_done']}",
                 region=FEDERATION_TRACK,
                 round=int(manifest["rounds_done"]),
                 t_sim=max((t.wall_clock for t in engine.trainers),
                           default=0.0),
                 rounds_done=int(manifest["rounds_done"]),
                 scenario=manifest["scenario"])
        tr.metrics.counter("engine.resumes").inc()
    return engine
