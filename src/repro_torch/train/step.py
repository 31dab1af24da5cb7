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
* gradient sync through the paper's collectives (``grad_sync``) is the
  multi-rank slice (ROADMAP A.3): passing one raises.

The gradient is taken with ``torch.autograd.grad`` on detached aliases of
the parameters, so the parameter tensors themselves never carry
``requires_grad`` or ``.grad``; AdamW then updates them in place.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.optim.adamw import AdamWConfig, apply_updates
from repro_torch.train.state import TrainState
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

AUX_WEIGHT = 0.01

Batch = Dict[str, torch.Tensor]


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


def _split_microbatches(batch: Batch, n: int):
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    size = b // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, remat: bool = True,
                    grad_sync: Any = None,
                    use_kernel: Optional[bool] = None
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch) -> (state, metrics)``; metrics hold
    ``loss``, ``grad_norm`` and ``lr`` (and ``ce``, ``aux`` without
    microbatching), as the reference's.  The state's tensors are updated
    in place and returned."""
    if grad_sync is not None:
        raise NotImplementedError(
            "grad_sync: gradient sync through the paper's collectives is "
            "the multi-rank slice of the port (ROADMAP A.3)")

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


__all__ = ["AUX_WEIGHT", "cross_entropy", "loss_fn", "make_decode_step",
           "make_prefill_step", "make_train_step", "value_and_grad"]
