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
  medium``): the spec moves "model" onto d_model (``spec_for_param``
  mirrors the reference's specs), but the execution pads the vocabulary
  instead (:func:`padded_vocab`), where the reference lets GSPMD pad it.

Norm weights, the MoE router and those whole ``wk`` / ``wv`` stay
replicated.

The embedding is always vocab-parallel (rows) and the head's columns give
each rank its block of the logits: rank r holds the ids [r Vp / m,
(r + 1) Vp / m) of the vocabulary padded to Vp, the next multiple of m.
The pad ids (>= V) have zero embedding rows and head columns; token ids
are below V, so no lookup reads a pad row, and the cross entropy masks the
pad columns out (``train.step.cross_entropy``), so their every gradient
is exactly zero.  The last ranks' blocks are copies (their real ids, then
zeros); ``unshard_params`` strips the padding.

Heads that do not divide the model axis are padded, where the reference
lets GSPMD pad them (:func:`padded_heads`): multi-head attention pads
its q and kv heads alike to the next multiple of m (``minicpm-2b``'s
36 / 36 to 40 / 40 at 8, 48 / 48 at 16); GQA with fewer kv heads than
ranks pads each kv group's q heads to a multiple of m / kv (56 / 8 to
64 / 8 at 16), so that each rank's q heads still lie in one group.  A
pad head has zero ``wq`` (and, MHA, ``wk`` / ``wv``) columns and zero
``wo`` rows; the model multiplies its attention output by zero
(``transformer._mask_pad_heads``), so its every gradient is exactly
zero too.  A rank's block of a padded leaf is a copy (its real heads,
then zeros); ``unshard_params`` strips the padding.  Any other dim the
execution cannot cut raises, naming the config and m; nothing is
silently replicated.

The data cut (ZeRO-3, ``shard_params(..., data_cut=True)``): each leaf
the spec cuts over "data" (``spec_for_param`` under ``fsdp``, leaves
below ``replicate_small_below`` staying whole) is cut again within the
rank's model block, into that many equal blocks of the spec's dim
(``embed`` and ``head`` under the spec of their padded shapes, whose
"model" cuts the vocabulary: d_model over "data" within the rank's
vocabulary block).  The model gathers each layer's leaves over "data"
just before it runs them
(``layers.gather_layer``) and reduce-scatters their gradients back.
Which cuts a tree carries is read off its shapes under the grid it runs
on (:func:`tree_cuts`, the one rule; :func:`tp_degree` is its model
half).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.collectives.comm import GridComm
from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_leaves, tree_unflatten

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
    "embed": 0, "head": 1,
}


def _model_size(grid: GridLike, policy: Optional[ShardingPolicy]) -> int:
    policy = for_grid(grid) if policy is None else policy
    return policy.axis_size(policy.model_axis)


def _refuse(cfg: ArchConfig, m: int, what: str) -> None:
    raise ValueError(f"{cfg.name}: the model axis of {m} cannot cut {what} "
                     f"(no silent replication)")


def padded_heads(cfg: ArchConfig, m: int) -> Tuple[int, int]:
    """(q heads, kv heads) of the execution layout over a model axis of
    ``m``: the config's where they divide it (or the kv heads are fewer
    than the ranks, each rank's q heads in one group), else padded (the
    module docstring); a shape neither cuts nor pads raises."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if m == 1 or not h or (h % m == 0 and (kv % m == 0 or m % kv == 0)):
        return h, kv
    if h == kv:                                  # MHA: q and kv alike
        hp = -(-h // m) * m
        return hp, hp
    if m % kv:
        _refuse(cfg, m, f"{kv} kv heads")
    per = m // kv                                # ranks a kv group spans
    return -(-(h // kv) // per) * per * kv, kv


def _kv_replicated(cfg: ArchConfig, m: int) -> bool:
    """Whether ``wk`` / ``wv`` stay whole: fewer (padded) kv heads than
    ranks, each rank's q heads in one kv head's group."""
    return m > 1 and padded_heads(cfg, m)[1] % m != 0


def padded_vocab(cfg: ArchConfig, m: int) -> int:
    """The vocabulary of the execution layout over a model axis of ``m``:
    the next multiple of ``m`` (the config's where ``m`` divides it)."""
    return -(-cfg.vocab_size // m) * m


#: leaves whose model dim holds the vocabulary
_VOCAB_LEAVES = ("embed", "head")


def _exec_shape(cfg: ArchConfig, m: int, name: str, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """A leaf's whole shape in the execution layout: ``embed`` / ``head``
    with the padded vocabulary."""
    shape = tuple(shape)
    if name not in _VOCAB_LEAVES:
        return shape
    dim = _EXEC_DIMS[name]
    return shape[:dim] + (padded_vocab(cfg, m),) + shape[dim + 1:]


def exec_layout(cfg: ArchConfig, m: int) -> Dict[str, Any]:
    """Leaf name -> how the execution cuts it over a model axis of ``m``
    (a dim, "pair", or None: whole on every rank); raises where the
    config does not cut."""
    if m == 1:
        return {}
    out = dict(_EXEC_DIMS)
    if cfg.family in ("dense", "moe", "hybrid", "encdec"):
        padded_heads(cfg, m)                     # raises by name
        if _kv_replicated(cfg, m):
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
    return out


# ---------------------------------------------------------------------- #
# padded heads: which of a rank's heads are real
# ---------------------------------------------------------------------- #
#: leaves whose model dim holds q heads / kv heads
_Q_LEAVES = ("wq", "wo", "x_wq", "x_wo")
_KV_LEAVES = ("wk", "wv", "x_wk", "x_wv")

#: (first real head, real heads, pad heads) of one rank's block
HeadBlock = Tuple[int, int, int]


def _real_head(p: int, groups: int, g: int, gp: int) -> Optional[int]:
    """The real head at padded position ``p`` (groups of ``g`` real heads
    padded to ``gp``), or None for a pad head."""
    if p % gp >= g or p // gp >= groups:
        return None
    return (p // gp) * g + p % gp


def _padding(cfg: ArchConfig, m: int, kind: str) -> Tuple[int, int, int, int]:
    """(padded heads, groups, g, gp) of the q ("q") or kv ("kv") heads."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    hp, kvp = padded_heads(cfg, m)
    if kind == "q":
        return hp, kv, h // kv, hp // kvp
    return kvp, kv, 1, 1


@functools.lru_cache(maxsize=256)
def head_block(cfg: ArchConfig, m: int, r: int, kind: str = "q"
               ) -> Optional[HeadBlock]:
    """Rank ``r``'s block of the q ("q") or kv ("kv") heads over a model
    axis of ``m`` where they are padded: its real heads (contiguous, from
    the first) and then its pad heads; None where nothing is padded."""
    if m == 1 or padded_heads(cfg, m) == (cfg.num_heads, cfg.num_kv_heads):
        return None
    total, groups, g, gp = _padding(cfg, m, kind)
    n = total // m
    real = [_real_head(p, groups, g, gp) for p in range(r * n, (r + 1) * n)]
    k = sum(x is not None for x in real)
    first = real[0] if k else 0
    if real != list(range(first, first + k)) + [None] * (n - k):
        raise AssertionError(f"{cfg.name}: rank {r}'s heads {real}")
    return first, k, n - k


def vocab_block(cfg: ArchConfig, m: int, r: int) -> HeadBlock:
    """Rank ``r``'s block of the padded vocabulary over a model axis of
    ``m``: (its first id, its real ids, its pad ids), the real ones
    first."""
    n = padded_vocab(cfg, m) // m
    real = min(n, max(0, cfg.vocab_size - r * n))
    return r * n, real, n - real


def real_heads(cfg: ArchConfig, m: int, r: int) -> int:
    """How many of rank ``r``'s q heads are real (the first ones)."""
    blk = head_block(cfg, m, r)
    return padded_heads(cfg, m)[0] // m if blk is None else blk[1]


def _head_kind(cfg: ArchConfig, m: int, name: str) -> Optional[str]:
    """"q" / "kv" for a leaf cut over padded heads, else None."""
    if name in _Q_LEAVES:
        return "q"
    if name in _KV_LEAVES and not _kv_replicated(cfg, m):
        return "kv"
    return None


def _cut_padded(x: torch.Tensor, dim: int, hd: int, blk: HeadBlock
                ) -> torch.Tensor:
    """A rank's block of a padded leaf: its real heads' slice of ``x``
    along ``dim``, then zeros for its pad heads (a copy unless it has
    none)."""
    first, n_real, n_pad = blk
    parts = []
    if n_real:
        parts.append(x.narrow(dim, first * hd, n_real * hd))
    if n_pad:
        shape = list(x.shape)
        shape[dim] = n_pad * hd
        parts.append(x.new_zeros(shape))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _strip_padding(x: torch.Tensor, dim: int, hd: int, cfg: ArchConfig,
                   m: int, kind: str) -> torch.Tensor:
    """A padded leaf gathered whole, its pad heads taken out."""
    total, groups, g, gp = _padding(cfg, m, kind)
    keep = [p for p in range(total) if _real_head(p, groups, g, gp)
            is not None]
    idx = (torch.tensor(keep, device=x.device)[:, None] * hd
           + torch.arange(hd, device=x.device)).reshape(-1)
    return x.index_select(dim, idx)


# ---------------------------------------------------------------------- #
# one rank's blocks
# ---------------------------------------------------------------------- #
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


def _named_leaves(tree: Any, path: tuple = (), lead: tuple = ()) -> list:
    """(path, stacked lead dims, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], path + (k,), lead)]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, path + (i,), lead + (len(tree),))]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, path + (i,), lead)]
    return [(path, lead, tree)]


def _leaf_name(path: tuple) -> str:
    names = [k for k in path if isinstance(k, str)]
    return names[-1] if names else ""


def _model_dim(how: Any, ndim: int) -> Optional[int]:
    return ndim - 1 if how == "pair" else how


def _whole_meta(cfg: ArchConfig) -> Any:
    from repro_torch.models.transformer import param_specs
    return param_specs(cfg)


@functools.lru_cache(maxsize=64)
def _data_candidates(cfg: ArchConfig, m: int, n: int
                     ) -> Tuple[Tuple[Optional[int], int], ...]:
    """For each leaf of ``cfg``'s tree (leaf order): the dim of its model
    block the data cut of ``n`` takes (the spec's "data" dim under
    ``fsdp``; None where the spec has none or the block does not split
    into n), and the leaf's stacked size (``replicate_small_below``
    decides on it)."""
    policy = ShardingPolicy(fsdp=True, axis_sizes=(("data", n), ("model", m)),
                            replicate_small_below=0)
    layout = exec_layout(cfg, m)
    out = []
    for path, lead, leaf in _named_leaves(_whole_meta(cfg)):
        name = _leaf_name(path)
        shape = _exec_shape(cfg, m, name, leaf.shape)
        spec = spec_for_param(path, lead + shape, policy)
        spec = spec[len(spec) - leaf.dim():] if len(spec) >= leaf.dim() \
            else spec
        dims = [i for i, a in enumerate(spec) if a == "data" or (
            isinstance(a, tuple) and "data" in a)]
        dim = None
        if dims:
            i = dims[0]
            cut = _model_dim(layout.get(name), leaf.dim()) == i
            local = shape[i] // (m if cut else 1)
            dim = i if local % n == 0 else None
        out.append((dim, math.prod(lead) * leaf.numel()))
    return tuple(out)


def data_cut_dims(cfg: ArchConfig, m: int, n: int,
                  policy: Optional[ShardingPolicy] = None
                  ) -> Tuple[Optional[int], ...]:
    """For each leaf (leaf order): the dim the data cut of ``n`` takes in
    the rank's model block, or None for a leaf whole over "data" (no
    "data" in its spec, or a stacked size below the policy's
    ``replicate_small_below``)."""
    if n == 1:
        return (None,) * len(_data_candidates(cfg, m, 1))
    small = ShardingPolicy().replicate_small_below if policy is None \
        else policy.replicate_small_below
    return tuple(dim if size >= small else None
                 for dim, size in _data_candidates(cfg, m, n))


def shard_for_rank(params: Any, cfg: ArchConfig, m: int, r: int,
                   n: int = 1, d: int = 0,
                   policy: Optional[ShardingPolicy] = None) -> Any:
    """Rank ``r``'s tree of ``m`` model ranks under the execution layout
    and, with ``n`` > 1, data rank ``d``'s block of it (the data cut of
    ``policy``): views of ``params`` (``in_proj`` and padded leaves
    copies of their blocks); leaves whole on every rank are the same
    tensors."""
    layout = exec_layout(cfg, m)
    hd = cfg.resolved_head_dim

    def model_cut(name, x):
        how = layout.get(name)
        if how is None:
            return x
        if name in _VOCAB_LEAVES:
            return _cut_padded(x, how, 1, vocab_block(cfg, m, r))
        kind = _head_kind(cfg, m, name)
        blk = None if kind is None else head_block(cfg, m, r, kind)
        if blk is not None:
            return _cut_padded(x, how, hd, blk)
        return _cut(x, how, m, r)

    out = _map_named(model_cut, params)
    if n == 1:
        return out
    dims = data_cut_dims(cfg, m, n, policy)
    leaves = tree_leaves(out)
    if len(leaves) != len(dims):
        raise ValueError(f"{cfg.name}: a tree of {len(leaves)} leaves, not "
                         f"the config's {len(dims)}")
    return tree_unflatten(out, [
        x if dim is None else x.narrow(dim, d * (x.shape[dim] // n),
                                       x.shape[dim] // n)
        for x, dim in zip(leaves, dims)])


def _data_size(grid: GridComm) -> int:
    return grid.axis_size("data") if "data" in grid.axis_names else 1


def shard_params(params: Any, cfg: ArchConfig, grid: GridComm,
                 policy: Optional[ShardingPolicy] = None,
                 data_cut: bool = False) -> Any:
    """This rank's shards of the whole tree ``params`` over the grid's
    model axis (the policy's ``model_axis``, default "model"): the
    execution layout of the module docstring; with ``data_cut`` also
    over the grid's "data" axis (ZeRO-3).  Views where a block is
    contiguous in memory or strided, so rank threads of one card share
    one weight set."""
    policy = for_grid(grid) if policy is None else policy
    m = _model_size(grid, policy)
    n = _data_size(grid) if data_cut else 1
    if m == 1 and n == 1:
        return params
    r = grid.axis_index(policy.model_axis) if m > 1 else 0
    d = grid.axis_index("data") if n > 1 else 0
    return shard_for_rank(params, cfg, m, r, n, d, policy)


def unshard_params(params: Any, cfg: ArchConfig, grid: GridComm,
                   policy: Optional[ShardingPolicy] = None) -> Any:
    """The whole tree on every rank, each cut leaf gathered over "data"
    (a tree cut over it, :func:`tree_cuts`) and over the model axis, the
    pad heads taken out (every rank must call this): the inverse of
    :func:`shard_params`, exact."""
    policy = for_grid(grid) if policy is None else policy
    cuts = tree_cuts(params, cfg, grid)
    if cuts.data > 1:
        comm = grid.sub("data")
        leaves = tree_leaves(params)
        params = tree_unflatten(params, [
            x if dim is None else torch.cat(
                list(comm.all_gather(x.contiguous()[None])), dim)
            for x, dim in zip(leaves, cuts.data_dims)])
    m = _model_size(grid, policy)
    if m == 1:
        return params
    layout = exec_layout(cfg, m)
    comm = grid.sub(policy.model_axis)
    hd = cfg.resolved_head_dim

    def gather(name, x):
        how = layout.get(name)
        if how is None:
            return x
        whole = _join(list(comm.all_gather(x.contiguous()[None])), how)
        if name in _VOCAB_LEAVES:
            return whole.narrow(how, 0, cfg.vocab_size)
        kind = _head_kind(cfg, m, name)
        if kind is not None and head_block(cfg, m, 0, kind) is not None:
            whole = _strip_padding(whole, how, hd, cfg, m, kind)
        return whole

    return _map_named(gather, params)


# ---------------------------------------------------------------------- #
# the one rule: which cuts a tree carries
# ---------------------------------------------------------------------- #
class Cuts(NamedTuple):
    """The model axis size a tree was cut by, the data axis size (1: whole
    over "data") and, for each leaf in leaf order, whether a rank holds
    only its model block of it (all False for a whole tree) and its
    data-cut dim (None: whole over "data"; all None without a data
    cut)."""
    model: int
    data: int
    model_cut: Tuple[bool, ...]
    data_dims: Tuple[Optional[int], ...]


@functools.lru_cache(maxsize=64)
def _rank_shapes(cfg: ArchConfig, m: int) -> Tuple[Tuple[int, ...], ...]:
    """Each leaf's shape in a rank's model-cut tree (every rank's)."""
    return tuple(tuple(x.shape) for x in tree_leaves(
        shard_for_rank(_whole_meta(cfg), cfg, m, 0)))


def _embed_degree(params: Any, cfg: ArchConfig) -> int:
    """The model axis whose rank holds ``params["embed"]``: its rows are
    the padded vocabulary's 1 / m (:func:`padded_vocab`)."""
    shape = tuple(params["embed"].shape)
    v, d = cfg.vocab_size, cfg.d_model
    if shape == (v, d):
        return 1
    if shape[1] == d and shape[0]:
        m = -(-v // shape[0])
        if m > 1 and padded_vocab(cfg, m) == m * shape[0]:
            return m
    raise ValueError(f"{cfg.name}: an embedding of {shape} is neither "
                     f"whole ({v}, {d}) nor a model-axis block of it")


def _grid_cuts(leaves: list, cfg: ArchConfig, m: int, n: int
               ) -> Optional[Tuple[Optional[int], ...]]:
    """Each leaf's data-cut dim when ``leaves`` are a rank's tree over a
    model axis of ``m`` cut (or not) over a data axis of ``n``; None when
    they are not."""
    try:
        shapes = _rank_shapes(cfg, m)
    except ValueError:
        return None
    if len(shapes) != len(leaves):
        return None
    cands = _data_candidates(cfg, m, n) if n > 1 else None
    dims = []
    for i, (x, want) in enumerate(zip(leaves, shapes)):
        got = tuple(x.shape)
        if got == want:
            dims.append(None)
            continue
        dim = None if cands is None else cands[i][0]
        if dim is None or got != want[:dim] + (want[dim] // n,) \
                + want[dim + 1:]:
            return None
        dims.append(dim)
    return tuple(dims)


def _model_cut(params: Any, cfg: ArchConfig, m: int) -> Tuple[bool, ...]:
    layout = exec_layout(cfg, m) if m > 1 else {}
    return tuple(tree_leaves(_map_named(
        lambda name, x: layout.get(name) is not None, params)))


def tree_cuts(params: Any, cfg: ArchConfig, grid: Optional[GridComm] = None
              ) -> Cuts:
    """The one rule that says how ``params`` is cut: under ``grid`` (by
    default the thread's ambient grid) its leaves' shapes are held
    against a rank's tree of the grid's model axis, cut or not over its
    "data" axis; without a grid, or where they are neither, the model
    cut is read off the embedding (a whole tree, or one rank's model
    block of it; anything else raises)."""
    if grid is None:
        from repro_torch.models.layers import _ambient_grid
        grid = _ambient_grid()
    leaves = None
    if grid is not None:
        names = grid.axis_names
        m = grid.axis_size("model") if "model" in names else 1
        n = _data_size(grid)
        if m > 1 or n > 1:
            leaves = tree_leaves(params)
            dims = _grid_cuts(leaves, cfg, m, n)
            if dims is not None:
                cut = any(x is not None for x in dims)
                return Cuts(m, n if cut else 1, _model_cut(params, cfg, m),
                            dims)
    m = _embed_degree(params, cfg)
    n_leaves = len(leaves if leaves is not None else tree_leaves(params))
    return Cuts(m, 1, _model_cut(params, cfg, m), (None,) * n_leaves)


def tp_degree(params: Any, cfg: ArchConfig) -> int:
    """The model axis size ``params`` was cut by (1 for a whole tree):
    :func:`tree_cuts`' model half."""
    return tree_cuts(params, cfg).model


def model_sharded_leaves(params: Any, cfg: ArchConfig) -> List[bool]:
    """For each leaf in leaf order: whether a rank's tree holds only its
    model block of it (False for the leaves whole on every rank, and for
    every leaf of a whole tree)."""
    return list(tree_cuts(params, cfg).model_cut)


def data_sharded_leaves(params: Any, cfg: ArchConfig) -> List[bool]:
    """For each leaf in leaf order: whether it is cut over "data"."""
    return [d is not None for d in tree_cuts(params, cfg).data_dims]


__all__ = ["AxisSpec", "Cuts", "ShardingPolicy", "Spec",
           "batch_sharding_specs", "cache_specs", "data_cut_dims",
           "data_sharded_leaves", "exec_layout", "for_grid",
           "grad_sync_axes_for_grid", "head_block", "labels_spec",
           "local_shard", "logits_spec", "model_sharded_leaves",
           "padded_heads", "padded_vocab", "param_sharding_tree",
           "real_heads", "shard_for_rank", "shard_params", "spec_for_param",
           "tp_degree", "tree_cuts", "unshard_params", "vocab_block"]
