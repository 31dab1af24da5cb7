"""Nested dict / list / tuple containers of tensors (the port's stand-in
for JAX pytrees).  Leaves are visited in a fixed order: dict keys sorted,
as ``jax.tree`` orders them, and lists and tuples in order.

A list inside a parameter tree is the port's layer stack, which the
reference keeps as one ``[L, ...]`` array: ``stacked_ndims`` gives each
leaf's rank in that stacked layout (its own rank plus one per enclosing
list).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _children(tree):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def stacked_ndims(tree: Any, depth: int = 0) -> List[int]:
    """Each leaf's rank in the reference's stacked layout, in leaf
    order."""
    kids = _children(tree)
    if kids is None:
        return [tree.ndim + depth]
    inner = depth + isinstance(tree, list)
    return [n for kid in kids for n in stacked_ndims(kid, inner)]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(kid) for kid in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    columns: Tuple[List[Any], ...] = (tree_leaves(tree),
                                      *(tree_leaves(r) for r in rest))
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*columns)])


__all__ = ["stacked_ndims", "tree_leaves", "tree_map", "tree_unflatten"]
