"""AdamW + learning-rate schedules (cosine, WSD, linear, constant): the
counterpart of ``repro/optim/adamw.py`` for one device.

Moments are float32; ``master_weights`` keeps a float32 master copy of
every parameter (mixed-precision training).  Weight decay is decoupled
and applies where the reference applies it, to leaves of rank >= 2 in
the reference's layout: there the layer stack is one ``[L, ...]`` array,
so every per-layer leaf (norm weights and biases included) has rank >= 2
and decays, while the top-level ``ln_f`` does not (``tree.stacked_ndims``).

Unlike the reference, whose arrays are immutable, ``apply_updates``
updates the parameters, the moments and the masters **in place** and
returns the same tensors: at full width the optimizer state is most of
the device memory, and a second copy would not fit.  Scalars (the
learning rate, bias corrections) are computed in float32, as the
reference computes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.tree import stacked_ndims, tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: int
    master: Any = None   # float32 master copy (mixed-precision training)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_weights: bool = False   # float32 master params (bf16 training)
    schedule: str = "cosine"       # cosine | wsd | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_fraction: float = 0.1    # WSD: fraction of steps in decay phase
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step`` (the reference's float32 arithmetic,
    in numpy)."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    t = np.clip((step - f32(cfg.warmup_steps))
                / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                f32(0.0), f32(1.0))
    if cfg.schedule == "cosine":
        mult = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + np.cos(f32(math.pi) * t))
    elif cfg.schedule == "wsd":
        decay_start = 1.0 - cfg.decay_fraction
        in_decay = np.clip((t - decay_start) / cfg.decay_fraction,
                           f32(0.0), f32(1.0))
        mult = 1.0 - (1.0 - cfg.min_lr_ratio) * in_decay
    elif cfg.schedule == "linear":
        mult = 1.0 - (1.0 - cfg.min_lr_ratio) * t
    else:
        mult = f32(1.0)
    return float(f32(cfg.lr * warm) * f32(mult))


def init_state(params: Any, master_weights: bool = False) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    master = None
    if master_weights:
        master = tree_map(lambda p: p.detach().float().clone(), params)
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=0, master=master)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d
    tensor on the leaves' device)."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree_leaves(tree)]).sum())


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: AdamWState
                  ) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """One AdamW step with global-norm clipping, in place (see the module
    docstring).  Returns (params, state, {"grad_norm", "lr"})."""
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, count)
    f32 = np.float32
    b1c = float(1 - f32(cfg.b1) ** f32(count))
    b2c = float(1 - f32(cfg.b2) ** f32(count))
    use_master = state.master is not None
    flat_p = tree_leaves(params)
    flat_w = tree_leaves(state.master) if use_master else flat_p
    for p, g, m, v, w, rank in zip(flat_p, tree_leaves(grads),
                                   tree_leaves(state.mu),
                                   tree_leaves(state.nu), flat_w,
                                   stacked_ndims(params)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        w32 = w.float()
        if rank >= 2:   # decoupled weight decay on (stacked) matrices
            step = step + cfg.weight_decay * w32
        w32_new = w32 - lr * step
        if use_master:
            w.copy_(w32_new)
        p.copy_(w32_new)
    opt = AdamWState(mu=state.mu, nu=state.nu, count=count,
                     master=state.master)
    return params, opt, {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "global_norm",
           "init_state", "lr_at"]
