"""Bucketed gradient AllReduce with compression (the counterpart of
``repro/collectives/overlap.py``).

Distributed-optimization layer for pure-DP training (parameters
replicated over the data / pod axes):

* **Bucketing**: gradients are flattened in the reference's stacked
  order (``tree.flatten_stacked``: all layers of one weight side by
  side) and packed into float32 buckets of ``bucket_bytes // 4``
  elements; each bucket is AllReduced on its own, so the engine picks
  the algorithm (one axis) or the joint topology plan (several axes) per
  bucket size.
* **Order**: buckets are reduced in reverse order, last layers first, as
  the reference issues them.  Every rank issues the same sequence of
  collectives, so the order is the same on every rank; nothing overlaps
  the backward yet.
* **Compression**: optional bf16 reduction with a float32 error
  feedback (the residual, carried between steps by the caller).

The reference runs each bucket under ``shard_map`` over a mesh; here
every rank calls this function with its own gradients and its
``GridComm``.
"""

from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.collectives.api import get_engine
from repro_torch.collectives.comm import GridComm
from repro_torch.collectives.engine import CollectiveEngine
from repro_torch.tree import (flatten_stacked, tree_leaves, tree_map,
                              unflatten_stacked)

DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024

#: (tree to rebuild the shapes from, each leaf's dtype)
Meta = Tuple[Any, List[torch.dtype]]


def flatten_tree(tree: Any) -> Tuple[torch.Tensor, Meta]:
    """A tree as one float32 vector in stacked order, and the meta
    ``unflatten_tree`` needs to restore shapes and dtypes (the FSDP
    flat-shard layout)."""
    return (flatten_stacked(tree),
            (tree, [leaf.dtype for leaf in tree_leaves(tree)]))


def unflatten_tree(flat: torch.Tensor, meta: Meta) -> Any:
    like, dtypes = meta
    return unflatten_stacked(like, flat, dtypes)


def _flatten_to_buckets(tree: Any, bucket_bytes: int
                        ) -> Tuple[torch.Tensor, List[torch.Tensor], Meta]:
    """The flat float32 vector and its buckets of ``bucket_bytes // 4``
    elements (views of it; the last may be shorter)."""
    flat, meta = flatten_tree(tree)
    n_per = max(1, bucket_bytes // 4)
    return flat, list(flat.split(n_per)), meta


def _axes(axes: Any) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def bucketed_allreduce(grads: Any, grid: GridComm,
                       axes: Sequence[str] = ("data",),
                       algorithm: str = "auto",
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                       compress: bool = False,
                       error_feedback: Optional[Any] = None,
                       mean: bool = True,
                       engine: Optional[CollectiveEngine] = None
                       ) -> Tuple[Any, Optional[Any]]:
    """AllReduce this rank's gradient tree over the grid's DP ``axes``,
    bucket by bucket through ``engine.allreduce_multi``; returns
    (reduced_grads, new_error_feedback).

    With ``error_feedback`` (a tree of float32 residuals) the gradients
    become ``g.float() + e`` first, and the result is float32.  With
    ``compress`` each bucket crosses the wire in bf16 and the new error
    feedback is ``bucket * n - reduced * n`` (n the folded DP size with
    ``mean``, else 1), the reference's residual; without it, None.
    """
    if engine is None:
        engine = get_engine(device=grid.device)
    axes = _axes(axes)
    if error_feedback is not None:
        grads = tree_map(lambda g, e: g.float() + e, grads, error_feedback)
    flat, buckets, meta = _flatten_to_buckets(grads, bucket_bytes)
    del grads
    n = math.prod(grid.axis_size(a) for a in axes)

    def reduce_bucket(b: torch.Tensor) -> torch.Tensor:
        v = b.to(torch.bfloat16) if compress else b
        v = engine.allreduce_multi(v, grid, axes, algorithm=algorithm)
        v = v.float()
        return v / n if mean else v

    # reverse order: last layers' buckets first (they finish backward
    # earliest).  Without compression each result goes back into its
    # bucket, a view of the flat vector: no second full-size copy.
    reduced: List[torch.Tensor] = list(buckets)
    for i in reversed(range(len(buckets))):
        r = reduce_bucket(buckets[i])
        if compress:
            reduced[i] = r
        else:
            buckets[i].copy_(r)
    if not compress:
        return unflatten_tree(flat, meta), None
    scale = n if mean else 1
    new_ef = unflatten_tree(torch.cat([b * scale - r * scale
                                       for b, r in zip(buckets, reduced)]),
                            meta)
    return unflatten_tree(torch.cat(reduced), meta), new_ef


def _axis_sizes(grid: Any, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    if isinstance(grid, GridComm):
        return tuple(grid.axis_size(a) for a in axes)
    names, shape = grid
    sizes = dict(zip(names, shape))
    return tuple(int(sizes[a]) for a in axes)


def bucket_algorithm_plan(grads: Any, grid: Any,
                          axes: Sequence[str] = ("data",),
                          bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                          engine: Optional[CollectiveEngine] = None
                          ) -> List[Tuple[int, str]]:
    """What the engine would run per bucket: ``(bytes, algorithm)``, the
    1D selector's algorithm on one axis, the joint plan's ``describe()``
    on several.  ``grid`` is a ``GridComm`` or its ``(axis names,
    shape)``; ``grads`` any tree of tensors (meta tensors too)."""
    if engine is None:
        engine = get_engine(device=getattr(grid, "device", None))
    axes = _axes(axes)
    sizes = _axis_sizes(grid, axes)
    total = sum(leaf.numel() * 4 for leaf in tree_leaves(grads))
    plan = []
    off = 0
    while off < total:
        b = min(bucket_bytes, total - off)
        if len(axes) == 1:
            plan.append((b, engine.select("allreduce", b,
                                          sizes[0]).algorithm))
        else:
            plan.append((b, engine.plan_multi("allreduce", axes, sizes,
                                              b).describe()))
        off += b
    return plan


__all__ = ["DEFAULT_BUCKET_BYTES", "bucket_algorithm_plan",
           "bucketed_allreduce", "flatten_tree", "unflatten_tree"]
