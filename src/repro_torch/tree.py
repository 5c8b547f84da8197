"""Parameter trees: nested dicts and lists of tensors, as in the reference.

The reference keeps model parameters as JAX pytrees of nested dicts (and,
for VGG-11, a list under ``params["convs"]``).  The port keeps the same
nesting with tensors at the leaves; these helpers walk it in the order
``jax.tree_util`` does (dict keys sorted, lists in order).
"""
from __future__ import annotations

from typing import Callable, List


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over one or more trees of the same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` leaf-wise, ``path`` the tuple of dict keys and
    list positions (as strings) from the root to the leaf, as the
    reference names a ``jax.tree_util`` key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, t, path + (str(i),))
                          for i, t in enumerate(tree))
    return fn(path, tree)
