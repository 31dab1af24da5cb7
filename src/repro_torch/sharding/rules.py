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

The execution layout over "model" (``shard_params`` / ``unshard_params``):
a rank's tree holds its 1/m of every leaf the rules shard over "model",
cut so that the block computes on its own: whole attention heads (``wq``,
``wk``, ``wv`` columns, ``wo`` rows, the cross-attention's ``x_*``
alike), its d_ff / m hidden units (``wg``, ``wu`` columns, ``wd`` rows),
its E / m experts, its di / m SSM channels and its RG-LRU blocks.  It
follows the specs' contiguous block but in three places, each because
the block would not compute on its own:

* ``in_proj`` [D, 2 di] is [x; z]: rank r takes its di / m channels of x
  **and** the same channels of z (``spec_for_param``'s column block
  would give rank 0 all of x and rank 1 all of z at m = 2);
* MQA / GQA with fewer kv heads than ranks (``recurrentgemma-9b``'s one
  kv head): the spec cuts the kv head's columns; the execution keeps
  ``wk`` / ``wv`` whole on every rank, and each rank attends with the
  kv heads its q heads use;
* a vocabulary "model" does not divide (``minicpm-2b``, ``whisper-
  medium``): the spec moves "model" onto d_model, and so does the
  execution: the embedding is column-sharded (its lookup gathered over
  "model"), the head row-sharded (its partial logits reduced).  With a
  vocabulary "model" divides, the embedding is vocab-parallel (rows) and
  the head's columns give each rank its block of the logits.

Norm weights, the MoE router and those whole ``wk`` / ``wv`` stay
replicated.  A dim the execution cannot cut raises, naming the config
and m; nothing is padded or silently replicated.  Whether a tree is one
rank's shards is read off its embedding alone (:func:`tp_degree`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.collectives.comm import GridComm
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_leaves

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


# ---------------------------------------------------------------------- #
# the execution layout over "model": one rank's shards of a tree
# ---------------------------------------------------------------------- #
#: leaf name -> the dim (of the leaf's own dims) cut into m blocks over
#: "model"; "pair" cuts both halves of the last dim alike (``in_proj``)
_EXEC_DIMS: Dict[str, Any] = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 0,
    "x_wq": 1, "x_wk": 1, "x_wv": 1, "x_wo": 0,
    "wg": 1, "wu": 1, "wd": 0,
    "eg": 0, "eu": 0, "ed": 0,
    "in_proj": "pair", "conv_w": 1, "x_proj": 0, "dt_w": 1, "dt_b": 0,
    "a_log": 0, "d_skip": 0, "out_proj": 0,
    "w_x": 1, "w_y": 1, "w_a": 0, "w_i": 0, "lam": 0, "out": 0,
}


def _model_size(grid: GridLike, policy: Optional[ShardingPolicy]) -> int:
    policy = for_grid(grid) if policy is None else policy
    return policy.axis_size(policy.model_axis)


def _refuse(cfg: ArchConfig, m: int, what: str) -> None:
    raise ValueError(f"{cfg.name}: the model axis of {m} cannot cut {what} "
                     f"(no padding, no silent replication)")


def _kv_replicated(cfg: ArchConfig, m: int) -> bool:
    """Whether ``wk`` / ``wv`` stay whole: fewer kv heads than ranks,
    each rank's q heads in one kv head's group."""
    return cfg.num_kv_heads % m != 0


def _vocab_rows(cfg: ArchConfig, m: int) -> bool:
    """The embedding vocab-parallel (True) or cut over d_model (False)."""
    return cfg.vocab_size % m == 0


def exec_layout(cfg: ArchConfig, m: int) -> Dict[str, Any]:
    """Leaf name -> how the execution cuts it over a model axis of ``m``
    (a dim, "pair", or None: whole on every rank); raises where the
    config does not cut."""
    if m == 1:
        return {}
    out = dict(_EXEC_DIMS)
    if cfg.family in ("dense", "moe", "hybrid", "encdec"):
        h, kv = cfg.num_heads, cfg.num_kv_heads
        if h % m:
            _refuse(cfg, m, f"{h} attention heads")
        if _kv_replicated(cfg, m):
            if m % kv:
                _refuse(cfg, m, f"{kv} kv heads")
            out.update(wk=None, wv=None, x_wk=None, x_wv=None)
        if cfg.family == "moe":
            if cfg.num_experts % m:
                _refuse(cfg, m, f"{cfg.num_experts} experts")
            if cfg.moe_dense_ff % m:
                _refuse(cfg, m, f"a dense residual of {cfg.moe_dense_ff}")
        elif cfg.d_ff % m:
            _refuse(cfg, m, f"a hidden dim of {cfg.d_ff}")
    if cfg.family == "ssm" and cfg.d_inner % m:
        _refuse(cfg, m, f"{cfg.d_inner} SSM channels")
    if cfg.family == "hybrid" and cfg.d_model % m:
        _refuse(cfg, m, f"an RG-LRU width of {cfg.d_model}")
    if _vocab_rows(cfg, m):
        out.update(embed=0, head=1)
    elif cfg.d_model % m == 0:
        out.update(embed=1, head=0)
    else:
        _refuse(cfg, m, f"a vocabulary of {cfg.vocab_size} or d_model "
                        f"{cfg.d_model}")
    return out


def _cut(x: torch.Tensor, how: Any, m: int, r: int) -> torch.Tensor:
    if how == "pair":
        x_half, z_half = x.chunk(2, dim=-1)
        n = x_half.shape[-1] // m
        return torch.cat([x_half.narrow(-1, r * n, n),
                          z_half.narrow(-1, r * n, n)], dim=-1)
    n = x.shape[how] // m
    return x.narrow(how, r * n, n)


def _join(parts, how: Any) -> torch.Tensor:
    if how == "pair":
        halves = [p.chunk(2, dim=-1) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim=-1)
    return torch.cat(parts, dim=how)


def _map_named(fn, tree: Any, name: str = "") -> Any:
    """``fn(leaf name, leaf)`` over a parameter tree (the name is the
    last dict key above the leaf)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def shard_for_rank(params: Any, cfg: ArchConfig, m: int, r: int) -> Any:
    """Rank ``r``'s tree of ``m`` model ranks under the execution layout:
    views of ``params`` (``in_proj`` a copy of its two blocks); leaves
    whole on every rank are the same tensors."""
    layout = exec_layout(cfg, m)
    return _map_named(lambda name, x: x if layout.get(name) is None
                      else _cut(x, layout[name], m, r), params)


def shard_params(params: Any, cfg: ArchConfig, grid: GridComm,
                 policy: Optional[ShardingPolicy] = None) -> Any:
    """This rank's shards of the whole tree ``params`` over the grid's
    model axis (the policy's ``model_axis``, default "model"): the
    execution layout of the module docstring.  Views where a block is
    contiguous in memory or strided, so rank threads of one card share
    one weight set."""
    policy = for_grid(grid) if policy is None else policy
    m = _model_size(grid, policy)
    if m == 1:
        return params
    return shard_for_rank(params, cfg, m, grid.axis_index(policy.model_axis))


def unshard_params(params: Any, cfg: ArchConfig, grid: GridComm,
                   policy: Optional[ShardingPolicy] = None) -> Any:
    """The whole tree on every rank, each sharded leaf gathered over the
    model axis (every rank of it must call this): the inverse of
    :func:`shard_params`, exact."""
    policy = for_grid(grid) if policy is None else policy
    m = _model_size(grid, policy)
    if m == 1:
        return params
    layout = exec_layout(cfg, m)
    comm = grid.sub(policy.model_axis)

    def gather(name, x):
        how = layout.get(name)
        if how is None:
            return x
        parts = comm.all_gather(x.contiguous()[None])
        return _join(list(parts), how)

    return _map_named(gather, params)


def model_sharded_leaves(params: Any, cfg: ArchConfig) -> list:
    """For each leaf in leaf order: whether a rank's tree holds only its
    block of it (False for the leaves whole on every rank, and for every
    leaf of a whole tree)."""
    m = tp_degree(params, cfg)
    layout = exec_layout(cfg, m)
    return tree_leaves(_map_named(
        lambda name, x: layout.get(name) is not None, params))


def tp_degree(params: Any, cfg: ArchConfig) -> int:
    """The one rule that says whether ``params`` is one rank's shards: the
    model axis size its embedding was cut by (1 for a whole tree)."""
    shape = tuple(params["embed"].shape)
    v, d = cfg.vocab_size, cfg.d_model
    if shape == (v, d):
        return 1
    if shape[1] == d and shape[0] and v % shape[0] == 0:
        return v // shape[0]
    if shape[0] == v and shape[1] and d % shape[1] == 0:
        return d // shape[1]
    raise ValueError(f"{cfg.name}: an embedding of {shape} is neither "
                     f"whole ({v}, {d}) nor a model-axis block of it")


__all__ = ["AxisSpec", "ShardingPolicy", "Spec", "batch_sharding_specs",
           "cache_specs", "exec_layout", "for_grid",
           "grad_sync_axes_for_grid", "labels_spec",
           "local_shard", "logits_spec", "model_sharded_leaves",
           "param_sharding_tree", "shard_for_rank", "shard_params",
           "spec_for_param", "tp_degree", "unshard_params"]
