"""Parameter containers: leaf order matching ``jax.tree_util``.

The reference numbers leaves in ``jax.tree_util.tree_leaves`` order,
which sorts dict keys (``b0, b1, b2, w0, w1, w2`` for the MLP), and the
leaf ordinal seeds every direction.  The port's parameters are plain
``dict[str, Tensor]`` (nested dicts allowed); these helpers walk them in
that same sorted order.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree: Any) -> list:
    """Leaves in sorted-key order (``jax.tree_util.tree_leaves``'s order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: list) -> Any:
    """Rebuild a tree shaped like ``like`` from leaves in sorted-key order."""
    return _build(like, iter(leaves))


def _build(node, it):
    # A module-level function: a nested recursive one would sit in a
    # reference cycle with its closure, keeping ``leaves`` alive until the
    # garbage collector runs.
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(sub, it) for sub in node)
    return next(it)
