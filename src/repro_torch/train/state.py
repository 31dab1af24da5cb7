"""Train state and its sharding helpers (counterpart of
``repro/train/state.py``): the specs of a state over a grid, a state of
meta tensors (nothing allocated), one rank's state over a model axis,
and over "data" too (``shard_train_state``), and its bytes, and the FSDP
flat state back to the parameter tree."""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.optim.adamw import AdamWState, init_state
from repro_torch.sharding.rules import (GridLike, ShardingPolicy,
                                        param_sharding_tree, shard_for_rank,
                                        shard_params)
from repro_torch.tree import tree_leaves, unflatten_stacked


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(params: Any, master_weights: bool = False
                     ) -> TrainState:
    return TrainState(params=params, opt=init_state(params, master_weights))


def train_state_shardings(state: TrainState, grid: GridLike,
                          policy: Optional[ShardingPolicy] = None
                          ) -> TrainState:
    """The state's specs (``sharding.rules``): the optimizer moments and
    the master copy inherit each parameter's spec; the step count is
    replicated, ``()``."""
    p_sh = param_sharding_tree(state.params, grid, policy)
    has_master = state.opt.master is not None
    return TrainState(params=p_sh, opt=AdamWState(
        mu=p_sh, nu=p_sh, count=(), master=p_sh if has_master else None))


def abstract_train_state(cfg, master_weights: bool = False) -> TrainState:
    """The train state of ``cfg`` as meta tensors: every shape and dtype,
    nothing allocated (the reference's ``jax.eval_shape``)."""
    from repro_torch.models import init_params
    return init_train_state(init_params(cfg, device="meta"), master_weights)


def shard_train_state(state: TrainState, cfg, grid,
                      policy: Optional[ShardingPolicy] = None,
                      data_cut: bool = False) -> TrainState:
    """This rank's state over the grid's model axis, and with
    ``data_cut`` over its "data" axis too (ZeRO-3): the parameters cut by
    ``sharding.rules.shard_params``, the moments and the master copy each
    inheriting its leaf's block, as the reference's
    ``train_state_shardings`` (tree-shaped state only)."""
    opt = state.opt
    for x in (opt.mu, opt.nu):
        if torch.is_tensor(x):
            raise ValueError("shard_train_state: a flat FSDP state; turn "
                             "it into a tree first (fsdp_state_to_tree)")

    def cut(tree):
        return None if tree is None else shard_params(tree, cfg, grid,
                                                      policy, data_cut)

    return TrainState(params=cut(state.params), opt=AdamWState(
        mu=cut(opt.mu), nu=cut(opt.nu), count=opt.count,
        master=cut(opt.master)))


def rank_state_bytes(cfg, m: int, master_weights: bool = False,
                     n: int = 1) -> dict:
    """A rank's bytes of parameters and of optimizer state over a model
    axis of ``m`` (its padded heads and vocabulary included) and a data
    cut of ``n`` (``abstract_train_state`` cut on the meta device; rank
    0's, every rank's are equal): {"params", "opt"}."""
    state = abstract_train_state(cfg, master_weights)

    def nbytes(tree):
        if tree is None:
            return 0
        return sum(x.numel() * x.element_size() for x in tree_leaves(
            shard_for_rank(tree, cfg, m, 0, n)))

    opt = state.opt
    return {"params": nbytes(state.params),
            "opt": nbytes(opt.mu) + nbytes(opt.nu) + nbytes(opt.master)}


def fsdp_state_to_tree(state: TrainState) -> TrainState:
    """The ``mode="fsdp"`` flat optimizer state back in the tree layout,
    so it resumes under ``mode="allreduce"`` (``apply_updates`` on
    per-parameter moments).

    ``fsdp_sync_apply`` leaves ``mu`` / ``nu`` (and ``master`` when
    enabled) as flat float32 vectors in stacked order; pass here the
    whole vector (this rank's shard gathered over the DP axes, the
    reference's global array).  The padding is stripped and each vector
    unflattened to the parameter tree, float32 as ``init_state`` makes
    it.  A state already tree-shaped passes unchanged; the round trip is
    exact."""
    leaves = tree_leaves(state.params)
    n = sum(leaf.numel() for leaf in leaves)
    f32 = [torch.float32] * len(leaves)

    def back(x):
        if not (torch.is_tensor(x) and x.dim() == 1 and x.numel() >= n):
            return x                        # already tree-shaped
        return unflatten_stacked(state.params, x[:n], f32)

    opt = state.opt
    return TrainState(params=state.params, opt=AdamWState(
        mu=back(opt.mu), nu=back(opt.nu), count=opt.count,
        master=back(opt.master)))


__all__ = ["TrainState", "abstract_train_state", "fsdp_state_to_tree",
           "init_train_state", "rank_state_bytes", "shard_train_state",
           "train_state_shardings"]
