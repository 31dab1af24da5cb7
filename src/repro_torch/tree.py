"""Nested dict / list / tuple containers of tensors (the port's stand-in
for JAX pytrees).  Leaves are visited in a fixed order: dict keys sorted,
as ``jax.tree`` orders them, and lists and tuples in order.

A list inside a parameter tree is the port's layer stack, which the
reference keeps as one ``[L, ...]`` array: ``stacked_ndims`` gives each
leaf's rank in that stacked layout (its own rank plus one per enclosing
list).
The reference flattens that stacked tree leaf by leaf, so all L layers of
one weight sit side by side in its flat vectors: ``stacked_order`` gives
the port's leaves in that order, and ``flatten_stacked`` /
``unflatten_stacked`` build and undo such a vector.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

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


def _stacked_groups(tree: Any, start: int = 0
                    ) -> Tuple[List[List[int]], int]:
    """Leaf indices grouped by the reference's stacked leaf they belong
    to (a list's children are zipped: group j holds leaf j of every
    layer, in layer order), and the next free index."""
    kids = _children(tree)
    if kids is None:
        return [[start]], start + 1
    per_kid = []
    for kid in kids:
        groups, start = _stacked_groups(kid, start)
        per_kid.append(groups)
    if not isinstance(tree, list):
        return [g for groups in per_kid for g in groups], start
    if any(len(g) != len(per_kid[0]) for g in per_kid):
        raise ValueError("the layers of a list differ in structure")
    return [[i for groups in per_kid for i in groups[j]]
            for j in range(len(per_kid[0]) if per_kid else 0)], start


def stacked_order(tree: Any) -> List[int]:
    """Indices into ``tree_leaves(tree)`` in the order the reference's
    ``jax.tree.flatten`` of the stacked tree visits the same values."""
    return [i for g in _stacked_groups(tree)[0] for i in g]


def flatten_stacked(tree: Any, pad: int = 0,
                    span: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Every leaf, cast to float32 and laid end to end in stacked
    order (the reference's flat vector of the stacked tree), then
    ``pad`` zeros; with ``span = (lo, hi)`` only elements ``[lo, hi)`` of
    that vector, built without the rest.  One allocation."""
    leaves = tree_leaves(tree)
    n = sum(leaf.numel() for leaf in leaves)
    lo, hi = span if span is not None else (0, n + pad)
    if not 0 <= lo <= hi <= n + pad:
        raise ValueError(f"span {(lo, hi)} outside a vector of {n + pad}")
    out = torch.zeros(hi - lo, dtype=torch.float32, device=leaves[0].device)
    off = 0
    for i in stacked_order(tree):
        k = leaves[i].numel()
        a, b = max(off, lo), min(off + k, hi)
        if a < b:
            out[a - lo:b - lo].copy_(leaves[i].reshape(-1)[a - off:b - off])
        off += k
    return out


def unflatten_stacked(like: Any, flat: torch.Tensor,
                      dtypes: Optional[List[torch.dtype]] = None) -> Any:
    """Inverse of :func:`flatten_stacked`: a tree shaped like ``like``
    whose leaves are views of ``flat`` (cast to ``dtypes``, by leaf, or to
    ``like``'s leaves' dtypes)."""
    leaves = tree_leaves(like)
    if dtypes is None:
        dtypes = [leaf.dtype for leaf in leaves]
    out: List[Any] = [None] * len(leaves)
    off = 0
    for i in stacked_order(like):
        n = leaves[i].numel()
        out[i] = flat[off:off + n].reshape(leaves[i].shape).to(dtypes[i])
        off += n
    if off != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} elements for a "
                         f"tree of {off}")
    return tree_unflatten(like, out)


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


__all__ = ["flatten_stacked", "stacked_ndims", "stacked_order", "tree_leaves",
           "tree_map", "tree_unflatten", "unflatten_stacked"]
