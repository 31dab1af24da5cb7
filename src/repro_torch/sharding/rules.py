"""Parallelism rules: DP / FSDP / TP / EP / SP as partition specs (the
counterpart of ``repro/sharding/rules.py``).

Grid axes: ``("data", "model")`` single-pod and ``("pod", "data",
"model")`` multi-pod, as the reference's meshes.

* TP ("model"): attention heads / FFN hidden / experts / SSM inner dim.
* FSDP ("data"): every parameter's non-TP matrix dim is additionally
  sharded over the data axis (ZeRO-3 style); optimizer states inherit.
* DP ("pod", "data"): batch dims of activations; gradients reduce over
  these axes.
* EP ("model"): MoE expert dim.
* Replicated: norms, small vectors.

There is no ``jax.sharding`` here.  A spec is a plain tuple with one
entry per dim: an axis name, a tuple of names (a folded, row-major
subset of the grid), or ``None``; ``()`` is replicated, the reference's
``P()``.  ``local_shard`` cuts this rank's block of a tensor under a
spec, the port's counterpart of ``jax.device_put(x, NamedSharding(mesh,
spec))``.

The reference's rules see stacked ``[L, ...]`` leaves; the port keeps a
list of per-layer trees.  ``param_sharding_tree`` computes each spec as
for the stacked leaf (its shape with one leading dim per enclosing list)
and drops those leading dims, which the rules always leave ``None``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.collectives.comm import GridComm
from repro_torch.configs.base import ArchConfig

#: one dim's entry: an axis, a folded tuple of axes, or None
AxisSpec = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisSpec, ...]
#: a grid of ranks, or its (axis names, shape)
GridLike = Union[GridComm, Tuple[Sequence[str], Sequence[int]]]


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True              # shard params over the data axis too
    data_axes: Tuple[str, ...] = ("data",)   # DP axes for activations
    model_axis: str = "model"
    fsdp_axis: Optional[str] = "data"
    axis_sizes: Tuple[Tuple[str, int], ...] = (("data", 1), ("model", 1))
    # hillclimb levers
    shard_vocab_model: bool = True
    replicate_small_below: int = 1 << 16  # params smaller than this stay
                                          # replicated

    def axis_size(self, axis: AxisSpec) -> int:
        sizes = dict(self.axis_sizes)
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return math.prod(sizes.get(a, 1) for a in axis)
        return sizes.get(axis, 1)

    def divides(self, axis: AxisSpec, dim: int) -> bool:
        n = self.axis_size(axis)
        return n > 0 and dim % n == 0

    def grad_sync_axes(self) -> Tuple[str, ...]:
        """The DP axes an explicit gradient sync must reduce over -- the
        axis tuple ``GradSyncConfig`` / the collective planner consume
        (outermost first, size-1 axes dropped)."""
        return tuple(a for a in self.data_axes if self.axis_size(a) > 1)


def _names_shape(grid: GridLike) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    if isinstance(grid, GridComm):
        return grid.axis_names, grid.shape
    names, shape = grid
    return tuple(names), tuple(int(s) for s in shape)


def for_grid(grid: GridLike, fsdp: bool = True) -> ShardingPolicy:
    """The policy a grid implies (the reference's ``for_mesh``)."""
    names, shape = _names_shape(grid)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    return ShardingPolicy(fsdp=fsdp, data_axes=data_axes,
                          fsdp_axis="data" if fsdp else None,
                          axis_sizes=tuple(zip(names, shape)))


def grad_sync_axes_for_grid(grid: GridLike) -> Tuple[str, ...]:
    """DP axis tuple a grid implies for explicit gradient sync."""
    return for_grid(grid).grad_sync_axes()


# last-key -> spec over the *trailing* dims (leading stacked dims -> None)
_PARAM_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("model", "fsdp"),
    "head": ("fsdp", "model"),
    "wq": ("fsdp", "model"), "wk": ("fsdp", "model"), "wv": ("fsdp", "model"),
    "wo": ("model", "fsdp"),
    "x_wq": ("fsdp", "model"), "x_wk": ("fsdp", "model"),
    "x_wv": ("fsdp", "model"), "x_wo": ("model", "fsdp"),
    "wg": ("fsdp", "model"), "wu": ("fsdp", "model"), "wd": ("model", "fsdp"),
    # the router stays replicated: the EP path consumes it whole
    "eg": ("model", "fsdp", None), "eu": ("model", "fsdp", None),
    "ed": ("model", None, "fsdp"),
    "in_proj": ("fsdp", "model"),
    "conv_w": (None, "model"),
    "x_proj": ("model", None),
    "dt_w": (None, "model"),
    "dt_b": ("model",),
    "a_log": ("model", None),
    "d_skip": ("model",),
    "out_proj": ("model", "fsdp"),
    "w_x": ("fsdp", "model"), "w_y": ("fsdp", "model"),
    "w_a": ("model", None, None), "w_i": ("model", None, None),
    "lam": ("model",),
    "out": ("model", "fsdp"),
}


def _resolve(axis: Optional[str], policy: ShardingPolicy) -> Optional[str]:
    if axis == "fsdp":
        return policy.fsdp_axis if policy.fsdp else None
    if axis == "model":
        return policy.model_axis
    return axis


def spec_for_param(path: Sequence[Any], shape: Sequence[int],
                   policy: ShardingPolicy) -> Spec:
    """The spec of the (stacked) parameter at ``path`` (dict keys and
    list indices; the last key names it) with ``shape``."""
    name = str(path[-1]) if path else ""
    shape = tuple(shape)
    rule = _PARAM_RULES.get(name)
    if rule is None or math.prod(shape) < policy.replicate_small_below:
        return ()
    if name == "embed" and not policy.shard_vocab_model:
        rule = (None, "fsdp")
    trailing = [_resolve(a, policy) for a in rule]
    lead = [None] * (len(shape) - len(trailing))
    if len(trailing) > len(shape):     # e.g. vectors in reduced configs
        trailing = trailing[-len(shape):]
        lead = []
    dims = lead + trailing
    # divisibility: drop axes that don't divide; for vocab-carrying
    # params try combining the remaining axes on the d_model dim instead
    # (odd vocabs: minicpm, whisper)
    for i, ax in enumerate(dims):
        if ax is not None and not policy.divides(ax, shape[i]):
            dims[i] = None
            if name in ("embed", "head"):
                j = len(lead) + 1 - (i - len(lead))  # the non-vocab dim
                flat: list = []
                for a in (dims[j], ax):
                    if a is not None:
                        flat.extend(a if isinstance(a, tuple) else (a,))
                combo = tuple(dict.fromkeys(flat))
                if combo and policy.divides(combo, shape[j]):
                    dims[j] = combo if len(combo) > 1 else combo[0]
    return tuple(dims)


def param_sharding_tree(params: Any, grid: GridLike,
                        policy: Optional[ShardingPolicy] = None) -> Any:
    """A tree shaped like ``params`` (tensors, meta tensors included)
    holding each leaf's spec.  A leaf inside k nested lists is ruled as
    the reference's stacked leaf (k leading layer dims), and its spec is
    that one without the k leading dims."""
    if policy is None:
        policy = for_grid(grid)

    def walk(node, path, lead):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,), lead) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,), lead + (len(node),))
                    for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return tuple(walk(v, path + (i,), lead)
                         for i, v in enumerate(node))
        spec = spec_for_param(path, lead + tuple(node.shape), policy)
        k = len(spec) - node.dim()
        if k < 0:
            return spec
        if any(a is not None for a in spec[:k]):
            raise ValueError(f"{path}: stacked spec {spec} shards a layer "
                             f"dim")
        return spec[k:]

    return walk(params, (), ())


# ---------------------------------------------------------------------- #
# activation / batch / cache specs
# ---------------------------------------------------------------------- #
def _dp_spec(policy: ShardingPolicy, batch_dim: int) -> AxisSpec:
    """Largest prefix of the DP axes that divides the batch dim."""
    dp = policy.data_axes
    while dp and not policy.divides(dp, batch_dim):
        dp = dp[1:] if policy.divides(dp[1:], batch_dim) else dp[:-1]
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def batch_sharding_specs(policy: ShardingPolicy,
                         batch_shapes: Dict[str, Any]) -> Dict[str, Spec]:
    """(dp, None, ...) per batch entry, dropping DP when indivisible
    (e.g. a global batch of 1)."""
    out: Dict[str, Spec] = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape)
        dp = _dp_spec(policy, shape[0]) if shape else None
        out[k] = (dp,) + (None,) * (len(shape) - 1)
    return out


def labels_spec(policy: ShardingPolicy) -> Spec:
    dp = policy.data_axes
    return (dp if len(dp) > 1 else (dp[0] if dp else None), None)


def _kv_cache_spec(policy: ShardingPolicy, shape: Sequence[int]) -> Spec:
    """[L, B, S, KV, hd]: prefer kv-head TP; fall back to sequence
    sharding (SP) when kv heads don't divide the model axis."""
    m = policy.model_axis
    _, b, s, kv, _ = shape
    dp = _dp_spec(policy, b)
    if policy.divides(m, kv):
        return (None, dp, None, m, None)
    if policy.divides(m, s):
        return (None, dp, m, None, None)
    return (None, dp, None, None, None)


def cache_specs(cfg: ArchConfig, policy: ShardingPolicy,
                cache_shapes: Dict[str, Any]) -> Dict[str, Spec]:
    """Specs matching an ``init_cache`` / ``prefill`` cache (shapes are
    needed for the divisibility decisions)."""
    m = policy.model_axis
    specs: Dict[str, Spec] = {}
    for key, leaf in cache_shapes.items():
        shape = tuple(leaf.shape)
        if key == "pos":
            specs[key] = ()
        elif key in ("k", "v", "enc_k", "enc_v"):
            specs[key] = _kv_cache_spec(policy, shape)
        elif key == "conv":       # [L, B, K-1, di]
            dp = _dp_spec(policy, shape[1])
            mm = m if policy.divides(m, shape[3]) else None
            specs[key] = (None, dp, None, mm)
        elif key == "h":           # ssm [L, B, di, N] / hybrid [L, B, lru]
            dp = _dp_spec(policy, shape[1])
            mm = m if policy.divides(m, shape[2]) else None
            specs[key] = (None, dp, mm) + (None,) * (len(shape) - 3)
        else:
            specs[key] = (None,) * len(shape)
    return specs


def logits_spec(policy: ShardingPolicy) -> Spec:
    dp = policy.data_axes
    return (dp if len(dp) > 1 else (dp[0] if dp else None), None,
            policy.model_axis)


# ---------------------------------------------------------------------- #
# this rank's block
# ---------------------------------------------------------------------- #
def local_shard(x: torch.Tensor, spec: Spec, grid: GridComm
                ) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: each sharded dim is cut
    into as many equal blocks as its axes have ranks, and the rank takes
    the block of its index along those axes (row-major over them, in the
    order given, as ``grid.sub(axes).rank``).  A dim the axes do not
    divide raises.  Returns a view."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more dims than {tuple(x.shape)}")
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = math.prod(grid.axis_size(a) for a in axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} blocks over {axes}")
        size = x.shape[dim] // n
        x = x.narrow(dim, grid.axes_index(axes) * size, size)
    return x


__all__ = ["AxisSpec", "ShardingPolicy", "Spec", "batch_sharding_specs",
           "cache_specs", "for_grid", "grad_sync_axes_for_grid",
           "labels_spec", "local_shard", "logits_spec",
           "param_sharding_tree", "spec_for_param"]
