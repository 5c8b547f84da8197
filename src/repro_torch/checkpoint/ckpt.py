"""Parameter-tree checkpointing (npz-based; no external deps).

The on-disk format is the JAX package's: one ``.npz`` whose keys are the
``/``-joined paths of dict keys and list indices, plus a ``.tree``
sidecar holding the tree's structure as ``jax.tree_util`` prints it
(``PyTreeDef({'fc': {'b': *, 'w': *}})``).  The port builds that string
from its own dicts and lists (:func:`treedef_str`), so a file written
by either package loads in the other.

Also provides ``handover_state``: the serialized blob a satellite
transmits to its successor (model + optimizer state + remaining-data
manifest), whose byte size feeds the handover-delay model (eq. 7).

Write discipline: both the ``.npz`` payload and its ``.tree`` structure
sidecar land via temp file + ``os.replace`` — a crash mid-save leaves
the previous checkpoint intact, never a torn file (the engine-level
snapshots in :mod:`repro_torch.checkpoint.engine` build on this).
"""
from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..convert import params_to_numpy


def _items(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree_util`` order: dict keys
    sorted, lists and tuples in order; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _items(t, path + (i,))
    elif tree is not None:
        yield path, tree


def _key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    return {_key(path): _numpy(leaf) for path, leaf in _items(tree)}


def treedef_str(tree) -> str:
    """The structure of ``tree`` as ``str(jax.tree_util.tree_structure(
    tree))`` prints it, for trees of dicts, lists, tuples and ``None``."""
    def walk(t) -> str:
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(x) for x in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


def _npz_path(path: str) -> str:
    """Normalized on-disk npz destination for ``path``."""
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_write_bytes(path: str, payload: bytes) -> None:
    """Write ``payload`` to ``path`` via temp file + ``os.replace``."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_pytree(tree, path: str) -> int:
    """Save a tree of tensors or arrays to ``path`` (npz + structure
    sidecar).  Returns bytes.

    Both files are written atomically (temp file + ``os.replace``); the
    byte count is that of the npz payload regardless of whether ``path``
    already carries the ``.npz`` suffix.
    """
    flat = _flatten_with_paths(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    npz = _npz_path(path)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    _atomic_write_bytes(npz, buf.getvalue())
    _atomic_write_bytes(npz + ".tree", treedef_str(tree).encode("utf-8"))
    return os.path.getsize(npz)


def _like(arr: np.ndarray, leaf):
    """``arr`` as ``leaf`` is: a tensor on its device with its dtype, or
    a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.asarray(arr)).to(device=leaf.device,
                                                    dtype=leaf.dtype)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def _rebuild(template, data, path: Tuple = ()):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], data, path + (k,))
                for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, data, path + (i,))
                              for i, t in enumerate(template))
    if template is None:
        return None
    return _like(data[_key(path)], template)


def load_pytree(template, path: str):
    """Load into the structure of ``template`` (keys must match): each
    leaf as the template's leaf is (a tensor on its device with its
    dtype, or a numpy array).

    Raises :class:`ValueError` on a leaf-key mismatch with the template
    and on a ``.tree`` structure-sidecar mismatch (when the sidecar
    exists — pre-hardening checkpoints may lack one).
    """
    path = _npz_path(path)
    data = np.load(path)
    keys = {_key(p) for p, _ in _items(template)}
    if keys != set(data.files):
        missing = sorted(keys - set(data.files))
        extra = sorted(set(data.files) - keys)
        raise ValueError(
            f"checkpoint structure mismatch for {path}: "
            f"missing keys {missing[:5]}{'...' if len(missing) > 5 else ''}, "
            f"unexpected keys {extra[:5]}{'...' if len(extra) > 5 else ''}")
    tree_path = path + ".tree"
    if os.path.exists(tree_path):
        with open(tree_path, "r", encoding="utf-8") as f:
            saved_def = f.read().strip()
        want_def = treedef_str(template).strip()
        if saved_def != want_def:
            raise ValueError(
                f"checkpoint treedef mismatch for {path}: saved structure "
                f"{saved_def!r} != template structure {want_def!r}")
    return _rebuild(template, data)


def handover_state(params, opt_state, data_manifest: Dict[str, Any]
                   ) -> Tuple[bytes, float]:
    """Serialize the satellite handover blob; returns (blob, bits).

    ``params`` and ``opt_state`` (trees in the port's layout; ``opt_state``
    may be ``None``) are written in the reference's layout
    (:func:`repro_torch.convert.params_to_numpy`), so the blob has the
    reference's keys, shapes and size.  The bit count is what enters
    eq. (7) as Q(w) (+ manifest overhead); the data samples themselves
    are counted separately via q|D_S|.
    """
    buf = io.BytesIO()
    opt = params_to_numpy(opt_state) if opt_state is not None else None
    flat = _flatten_with_paths({"params": params_to_numpy(params),
                                "opt": opt})
    np.savez(buf, **flat)
    manifest = json.dumps(data_manifest).encode()
    blob = manifest + b"\x00" + buf.getvalue()
    return blob, 8.0 * len(blob)
