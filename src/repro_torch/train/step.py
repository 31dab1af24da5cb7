"""Step builders: train (forward + backward + AdamW), prefill, decode --
the counterpart of ``repro/train/step.py`` for one device.

* loss: next-token cross entropy in float32 (+ the MoE load-balance aux
  term, 0 for the families ported so far);
* remat: per-layer activation checkpointing, in the model;
* microbatching: gradients accumulated in float32 over slices of the
  batch, then averaged, as the reference's scan over microbatches;
* the kernel route: ``use_kernel=None`` takes the hand-written kernels
  when the parameters live on a CUDA device -- the fused scan kernels for
  the SSM family, the flash-attention kernel for the dense family's
  long-sequence attention -- and the plain chunked scan and chunked
  attention on the CPU, as the port's server picks its attention kernel
  (the reference's trainer runs the jnp twins of those kernels:
  ROADMAP.md C6 and C9);
* gradient sync (``grad_sync``, a :class:`GradSyncConfig`): every rank
  runs the step on its own rows of the global batch, and the gradients
  cross the grid's DP axes through the paper's collectives -- bucketed
  AllReduce, or the FSDP reduce-scatter / flat-shard AdamW / allgather
  -- where the reference's jit + GSPMD partitions one program.  The
  loss (and ``ce``) each rank computes is over its own rows; it is
  averaged over the DP axes through the engine, so the metrics are the
  reference's global-batch ones.

The gradient is taken with ``torch.autograd.grad`` on detached aliases of
the parameters, so the parameter tensors themselves never carry
``requires_grad`` or ``.grad``; AdamW then updates them in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.collectives.comm import GridComm
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply_updates,
                                     lr_at)
from repro_torch.train.state import TrainState
from repro_torch.tree import (flatten_stacked, stacked_ndims, stacked_order,
                              tree_leaves, tree_map, tree_unflatten,
                              unflatten_stacked)

AUX_WEIGHT = 0.01

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass
class GradSyncConfig:
    """Explicit DP gradient synchronization through the engine, for the
    rank that holds ``grid``.

    ``mode="allreduce"`` (default): params replicated over ``axes``;
    after backward, gradients are bucketed and AllReduced with the
    planner's per-bucket-size cached joint topology plan
    (``collectives.overlap.bucketed_allreduce``).

    ``mode="fsdp"``: the ZeRO-style pair instead -- gradients are
    reduce-scattered over ``axes`` (each rank keeps its 1/P flat shard),
    the AdamW update runs on the shard against flat sharded optimizer
    state, and the updated params are allgathered, both halves through
    the engine's topology-aware plans.  ``master_weights`` is supported:
    the float32 master lives as one flat shard updated in place.
    ``compress`` is an allreduce-mode knob and is ignored here;
    ``algorithm`` picks the plan shape for all three phases ("auto" =
    planner argmin).

    ``fused=True`` (fsdp mode) routes the grad reduce-scatter through the
    engine's ``fused_matmul_reduce_scatter``.  The grad-sync site has no
    local GEMM to fuse (``w=None``), so this is the degenerate case: the
    engine's reduce-scatter, the same opt-in flag the tensor-parallel
    down-projection uses where a real GEMM feeds the ring
    (``models.layers.set_fused_tp``)."""

    grid: GridComm
    axes: Tuple[str, ...] = ("data",)
    algorithm: str = "auto"
    bucket_bytes: int = 4 * 1024 * 1024
    compress: bool = False
    mode: str = "allreduce"        # "allreduce" | "fsdp"
    fused: bool = False

    def __post_init__(self):
        if self.mode not in ("allreduce", "fsdp"):
            raise ValueError(f"unknown grad-sync mode {self.mode!r}; "
                             f"expected 'allreduce' or 'fsdp'")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits [B, S, V]; labels [B, S] int -> mean of (logsumexp - gold)
    in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def loss_fn(params: Any, cfg: ArchConfig, batch: Batch, remat: bool = True,
            use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    model_inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, aux = tf.forward_train(params, cfg, model_inputs, remat=remat,
                                   use_kernel=use_kernel)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def value_and_grad(params: Any, cfg: ArchConfig, batch: Batch,
                   remat: bool = True, use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """(loss, metrics, grads): ``jax.value_and_grad(loss_fn,
    has_aux=True)`` on the parameter tree; grads in the parameters'
    dtypes."""
    aliases = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, aliases), cfg, batch,
                            remat=remat, use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, aliases)
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def _decay_shard(params: Any, lo: int, hi: int,
                 device: torch.device) -> torch.Tensor:
    """Elements ``[lo, hi)`` of the flat decay mask: 1 where the element
    belongs to a leaf of stacked rank >= 2 (ROADMAP C7), else 0."""
    out = torch.zeros(hi - lo, dtype=torch.float32, device=device)
    leaves, ranks = tree_leaves(params), stacked_ndims(params)
    off = 0
    for i in stacked_order(params):
        size = leaves[i].numel()
        a, b = max(off, lo), min(off + size, hi)
        if ranks[i] >= 2 and a < b:
            out[a - lo:b - lo] = 1.0
        off += size
    return out


@torch.no_grad()
def fsdp_layout(params: Any, gs: GradSyncConfig
                ) -> Tuple[int, int, int, int]:
    """(P, n, pad, shard) of the FSDP flat layout over ``gs.axes``: the
    folded DP size P, the params' element count n, the zero padding that
    makes it a multiple of P, and the length of one rank's shard."""
    n_world = math.prod(gs.grid.axis_size(a) for a in gs.axes)
    n = sum(leaf.numel() for leaf in tree_leaves(params))
    pad = (-n) % n_world
    return n_world, n, pad, (n + pad) // n_world


def fsdp_sync_apply(opt_cfg: AdamWConfig, params: Any, grads: Any,
                    opt: AdamWState, gs: GradSyncConfig
                    ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """FSDP-style sync + update on this rank: reduce-scatter grads, AdamW
    on the flat shard, allgather the updated params -- every byte through
    the CollectiveEngine's topology-aware plans.

    Numerically the reference's: ``apply_updates`` on fully-synced grads
    (the same global clip, bias correction and matrix-only weight decay;
    float32 throughout), with the optimizer state as flat 1/P shards.
    The flat vector is the reference's stacked order
    (``tree.flatten_stacked``), zero-padded to a multiple of the folded
    DP size P; this rank holds elements ``[r * n / P, (r + 1) * n / P)``,
    r its index over ``gs.axes`` (row-major, in the order given), as the
    reference's device r under ``P(axes)``.  ``opt.mu`` / ``opt.nu`` (and
    ``opt.master`` with master weights) come back as those local shards;
    a tree-shaped state (step 0, or one restored from allreduce mode) is
    flattened and cut first.  The params are updated in place and
    returned."""
    from repro_torch.collectives.api import get_engine

    axes = tuple(gs.axes)
    if not axes:
        # no DP axes (a single rank): nothing to scatter or gather
        return apply_updates(opt_cfg, params, grads, opt)
    grid = gs.grid
    engine = get_engine(device=grid.device)
    n_world, n, pad, shard = fsdp_layout(params, gs)
    use_master = opt.master is not None
    leaves = tree_leaves(params)
    lo = grid.axes_index(axes) * shard
    hi = lo + shard

    def local(state: Any) -> torch.Tensor:
        """This rank's float32 shard of a flat or tree-shaped state."""
        if torch.is_tensor(state) and state.dim() == 1 \
                and state.numel() == shard:
            return state
        return flatten_stacked(state, pad=pad, span=(lo, hi))

    mu, nu = local(opt.mu), local(opt.nu)
    # the float32 working copy the update runs against: the persistent
    # master when enabled, else this step's cast of the params
    w32 = local(opt.master) if use_master else local(params)
    decay = _decay_shard(params, lo, hi, w32.device)
    # allgather in the model dtype when the params share one: the full
    # float32 master never needs to cross the wire
    dtypes = {leaf.dtype for leaf in leaves}
    gather_dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32

    count = opt.count + 1
    lr = lr_at(opt_cfg, count)
    f32 = np.float32
    b1c = float(1 - f32(opt_cfg.b1) ** f32(count))
    b2c = float(1 - f32(opt_cfg.b2) ** f32(count))

    flat_g = flatten_stacked(grads, pad=pad)
    if gs.fused:
        g_s = engine.fused_matmul_reduce_scatter(
            flat_g, None, grid, axes=axes, algorithm=gs.algorithm)
    else:
        g_s = engine.reduce_scatter_multi(flat_g, grid, axes,
                                          algorithm=gs.algorithm)
    del flat_g
    g_s = g_s / float(n_world)          # mean over the DP world
    sq = engine.allreduce_multi(g_s.square().sum().reshape(1), grid, axes,
                                algorithm=gs.algorithm)
    gnorm = torch.sqrt(sq[0])
    gg = g_s * torch.clamp(opt_cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    mu.mul_(opt_cfg.b1).add_((1 - opt_cfg.b1) * gg)
    nu.mul_(opt_cfg.b2).add_((1 - opt_cfg.b2) * gg.square())
    step = (mu / b1c) / (torch.sqrt(nu / b2c) + opt_cfg.eps)
    step = step + (opt_cfg.weight_decay * decay) * w32
    w2 = w32 - lr * step
    del step, gg, g_s
    w_full = engine.allgather_multi(w2.to(gather_dtype), grid, axes,
                                    algorithm=gs.algorithm)
    new = unflatten_stacked(params, w_full[:n])
    for p, q in zip(leaves, tree_leaves(new)):
        p.copy_(q)
    opt2 = AdamWState(mu=mu, nu=nu, count=count,
                      master=w2 if use_master else None)
    return params, opt2, {"grad_norm": gnorm, "lr": lr}


def _dp_mean(x: Any, gs: Optional[GradSyncConfig]) -> Any:
    """A rank's metric averaged over the DP axes through the engine (a
    non-tensor, such as the families' zero aux term, passes)."""
    if gs is None or not gs.axes or not torch.is_tensor(x):
        return x
    from repro_torch.collectives.api import get_engine
    n = math.prod(gs.grid.axis_size(a) for a in gs.axes)
    total = get_engine(device=gs.grid.device).allreduce_multi(
        x.detach().float().reshape(1), gs.grid, tuple(gs.axes),
        algorithm=gs.algorithm)
    return total[0] / n


def _split_microbatches(batch: Batch, n: int):
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    size = b // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, remat: bool = True,
                    grad_sync: Optional[GradSyncConfig] = None,
                    use_kernel: Optional[bool] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` (and ``ce``, ``aux`` without
    microbatching), as the reference's.  The state's tensors are updated
    in place and returned.

    With ``grad_sync`` the step runs on this rank's rows of the global
    batch and syncs through the engine over ``grad_sync.axes``: every
    rank of the grid must call it, with the same shapes, in the same
    order."""
    def train_step(state: TrainState, batch: Batch):
        uk = tf.kernel_route(state.params, use_kernel)
        if microbatches == 1:
            loss, metrics, grads = value_and_grad(
                state.params, cfg, batch, remat=remat, use_kernel=uk)
        else:
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device),
                state.params)
            loss = 0.0
            for mb in _split_microbatches(batch, microbatches):
                l_i, _, g = value_and_grad(state.params, cfg, mb,
                                           remat=remat, use_kernel=uk)
                for acc, gi in zip(tree_leaves(g_acc), tree_leaves(g)):
                    acc.add_(gi)
                loss = loss + l_i
                del g
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g.mul_(inv), g_acc)
            loss = loss * inv
            metrics = {}
        loss = _dp_mean(loss, grad_sync)
        metrics = {k: _dp_mean(v, grad_sync) for k, v in metrics.items()}
        if grad_sync is not None and grad_sync.mode == "fsdp":
            # ZeRO-style pair: reduce-scatter grads, update the flat
            # shard, allgather params -- all through the engine
            params, opt, opt_metrics = fsdp_sync_apply(
                opt_cfg, state.params, grads, state.opt, grad_sync)
            return TrainState(params=params, opt=opt), {
                "loss": loss, **metrics, **opt_metrics}
        if grad_sync is not None:
            # explicit pure-DP sync: every gradient byte goes through the
            # engine's cached dispatch
            from repro_torch.collectives.overlap import bucketed_allreduce
            grads, _ = bucketed_allreduce(
                grads, grad_sync.grid, axes=grad_sync.axes,
                algorithm=grad_sync.algorithm,
                bucket_bytes=grad_sync.bucket_bytes,
                compress=grad_sync.compress)
        params, opt, opt_metrics = apply_updates(opt_cfg, state.params,
                                                 grads, state.opt)
        return TrainState(params=params, opt=opt), {"loss": loss, **metrics,
                                                    **opt_metrics}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (logits, cache)``; on a CUDA
    device the SSM's scan takes the forward-only kernel and the dense
    family's long-prompt attention the flash kernel."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return tf.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    @torch.no_grad()
    def decode_step(params, cache, batch):
        return tf.decode_step(params, cfg, cache, batch)
    return decode_step


__all__ = ["AUX_WEIGHT", "GradSyncConfig", "cross_entropy",
           "fsdp_layout", "fsdp_sync_apply", "loss_fn", "make_decode_step",
           "make_prefill_step", "make_train_step", "value_and_grad"]
