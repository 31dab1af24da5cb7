"""A rank's tree cut over "data" too: the reference's ZeRO-3 (its
``"fsdp"`` entries, ``src/repro/sharding/rules.py:80-104``, moments
inheriting each leaf's sharding, ``src/repro/train/state.py:25-39``).

On (data 2, model 2) rank threads of the CPU, for each family (the MoE
through its EP body), held against the JAX package's step from the same
weights: each data rank's loss and gradients on its rows, their mean over
the data ranks (the reference's loss and ``jax.grad`` on each rank's
rows, averaged: the DP step's mean, ROADMAP C19) within 1e-5 / 1e-4,
the gradients of the leaves cut over "data" already that mean on every
rank (reduce-scattered in the backward), and one AdamW step on the
blocks against the reference's ``apply_updates`` on the mean gradient.
One case on (pod 2, data 2, model 1).  Prefill and greedy decode on
(data 2, model 2) threads: every rank's stream equal to the reference's
on its rows, logits within 1e-5.  The reduced configs' leaves are
all below ``replicate_small_below``, so these cut every leaf the spec
puts "data" on (``replicate_small_below=0``).

The layout: a rank's leaves follow the spec's "data" dims and stay whole
where the spec drops them; a rank's bytes equal ``rank_state_bytes``
with the data cut, at full width on meta tensors; existing callers get
the model-only tree; the one rule reads both cuts; a data-cut tree
refuses the flat FSDP sync and the paged route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import apply_updates as j_apply_updates
from repro.optim.adamw import init_state as j_init_state
from repro.train import step as jstep
from repro_torch.collectives import run_local_grid
from repro_torch.collectives.comm import CountingGridComm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import forward_train
from repro_torch.models.layers import ambient_grid
from repro_torch.models.paged import forward_paged, init_pages
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules
from repro_torch.train.state import (abstract_train_state, init_train_state,
                                     rank_state_bytes, shard_train_state)
from repro_torch.train.step import (GradSyncConfig, make_train_step,
                                    value_and_grad)
from repro_torch.tree import tree_leaves, tree_map
from torch_util import jax_params_numpy
from tp_util import Model, check_greedy

FAMILIES = ["yi-34b", "olmoe-1b-7b", "falcon-mamba-7b", "recurrentgemma-9b",
            "whisper-medium"]
GRIDS = {"data-model": ((2, 2), ("data", "model")),
         "pod-data": ((2, 2, 1), ("pod", "data", "model"))}
CASES = [(a, "data-model") for a in FAMILIES] + [("yi-34b", "pod-data")]
IDS = [f"{a}-{g}" for a, g in CASES]
OPT = dict(warmup_steps=1, total_steps=10)
TOL = dict(loss=(1e-5, 1e-6), grads=(1e-4, 1e-5), params=(1e-4, 1e-5))

_MODELS = {}
_RUNS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = Model(arch, batch=4)
    return _MODELS[arch]


def _policy(grid):
    return dataclasses.replace(rules.for_grid(grid), replicate_small_below=0)


def _dp(grid):
    """(this rank's DP index, the DP size) over the grid's DP axes."""
    axes = tuple(a for a in ("pod", "data") if a in grid.axis_names)
    return grid.axes_index(axes), int(np.prod([grid.axis_size(a)
                                               for a in axes]))


def _rows(batch, i, n):
    per = next(iter(batch.values())).shape[0] // n
    return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}


def _reference(model, n):
    """The reference's loss and gradients on each of ``n`` DP ranks'
    rows, averaged, and its AdamW step on that mean gradient."""
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, model.jcfg, b), has_aux=True))
    losses, grads = [], []
    for i in range(n):
        batch = {k: jnp.asarray(v) for k, v in _rows(model.batch, i,
                                                     n).items()}
        (loss, _), g = grad_fn(model.jp, batch)
        losses.append(float(loss))
        grads.append(g)
    mean = jax.tree.map(lambda *gs: sum(gs) / n, *grads)
    params, _, metrics = jax.jit(
        lambda p, g: j_apply_updates(JAdamWConfig(**OPT), p, g,
                                     j_init_state(p)))(model.jp, mean)
    as_port = lambda t: params_from_jax(jax_params_numpy(t), model.cfg,
                                        "cpu")
    return (float(np.mean(losses)), as_port(mean), as_port(params),
            float(metrics["grad_norm"]))


def _port(model, grid_key):
    """Each rank's (loss, whole grads, whole grads of its data-cut leaves'
    flags, loss after a step's metrics, whole params after one step)."""
    shape, names = GRIDS[grid_key]
    cfg = model.cfg

    def fn(grid):
        policy = _policy(grid)
        local = rules.shard_params(model.params, cfg, grid, policy,
                                   data_cut=True)
        i, n = _dp(grid)
        mine = _rows(model.tbatch(), i, n)
        with ambient_grid(grid):
            flags = rules.data_sharded_leaves(local, cfg)
            loss, _, grads = value_and_grad(local, cfg, mine)
            whole_grads = rules.unshard_params(grads, cfg, grid)
            state = init_train_state(tree_map(lambda t: t.clone(), local))
            gs = GradSyncConfig(grid=grid, axes=rules.grad_sync_axes_for_grid(
                grid), mode="allreduce")
            state, metrics = make_train_step(cfg, AdamWConfig(**OPT),
                                             grad_sync=gs)(state, mine)
            whole = rules.unshard_params(state.params, cfg, grid)
        return (float(loss), whole_grads, flags, float(metrics["loss"]),
                float(metrics["grad_norm"]), whole)

    key = (model.cfg.name, grid_key)
    if key not in _RUNS:
        _RUNS[key] = run_local_grid(fn, shape, names, "cpu", timeout=300)
    return _RUNS[key]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("arch,grid_key", CASES, ids=IDS)
def test_loss_and_gradients_match_reference(arch, grid_key):
    model = _model(arch)
    n = _dp(CountingGridComm(*GRIDS[grid_key]))[1]
    want_loss, want_grads, _, _ = model.memo(("zero3", n),
                                             lambda: _reference(model, n))
    out = _port(model, grid_key)
    assert any(out[0][2]) and not all(out[0][2])
    _close(np.mean([o[0] for o in out]), want_loss, TOL["loss"])
    leaves = [tree_leaves(o[1]) for o in out]
    for j, want in enumerate(tree_leaves(want_grads)):
        mean = sum(ls[j] for ls in leaves) / len(leaves)
        _close(mean.numpy(), want.numpy(), TOL["grads"])
        if out[0][2][j] and grid_key == "data-model":
            # cut over "data": the mean already, on every rank (with a
            # "pod" axis, the mean over its data ranks: the step
            # allreduces the pods)
            for ls in leaves:
                _close(ls[j].numpy(), want.numpy(), TOL["grads"])


@pytest.mark.parametrize("arch,grid_key", CASES, ids=IDS)
def test_one_step_on_the_blocks_matches_reference(arch, grid_key):
    model = _model(arch)
    n = _dp(CountingGridComm(*GRIDS[grid_key]))[1]
    want_loss, _, want_params, want_gnorm = model.memo(
        ("zero3", n), lambda: _reference(model, n))
    for _, _, _, loss, gnorm, whole in _port(model, grid_key):
        _close(loss, want_loss, TOL["loss"])
        _close(gnorm, want_gnorm, TOL["grads"])
        for a, b in zip(tree_leaves(whole), tree_leaves(want_params)):
            _close(a.numpy(), b.numpy(), TOL["params"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_greedy_streams_with_the_data_cut_match_reference(arch):
    # prefill and greedy decode on (data 2, model 2) threads, each data
    # rank on its rows: every layer loop's gather (the encoder's, the
    # hybrid's, the encoder-decoder's, the MoE body's expert blocks)
    # against the reference's streams
    check_greedy(_model(arch), 2, 2)


# ------------------------------ the layout ------------------------------ #
@pytest.mark.parametrize("arch", FAMILIES + ["minicpm-2b", "arctic-480b"])
def test_full_width_rank_bytes_equal_rank_state_bytes(arch):
    cfg = get_config(arch)
    grid = CountingGridComm((16, 16), ("data", "model"))
    state = shard_train_state(abstract_train_state(cfg), cfg, grid,
                              data_cut=True)
    want = rank_state_bytes(cfg, 16, n=16)
    nbytes = lambda t: sum(x.numel() * x.element_size()
                           for x in tree_leaves(t))
    assert nbytes(state.params) == want["params"]
    assert nbytes(state.opt.mu) + nbytes(state.opt.nu) == want["opt"]
    # each leaf is its model block cut over "data" where the spec puts
    # "data" on a leaf of 2^16 elements or more, whole elsewhere
    model_only = rules.shard_for_rank(abstract_train_state(cfg).params, cfg,
                                      16, 0)
    specs = rules.param_sharding_tree(abstract_train_state(cfg).params,
                                      grid)
    n_cut = 0
    for x, y, spec in zip(tree_leaves(state.params), tree_leaves(model_only),
                          _spec_leaves(specs)):
        has_data = any(a == "data" or (isinstance(a, tuple) and "data" in a)
                       for a in spec)
        assert x.numel() * (16 if has_data else 1) == y.numel(), spec
        n_cut += has_data
    assert n_cut > 0
    assert want["params"] < rank_state_bytes(cfg, 16)["params"]


def _spec_leaves(specs):
    """The specs of ``param_sharding_tree`` in leaf order (a spec is a
    tuple, which ``tree_leaves`` would walk into)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, list) or (isinstance(specs, tuple) and specs
                                   and isinstance(specs[0], dict)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def test_odd_vocabulary_cuts_model_first_then_data_within():
    """The vocabulary padded to 258 over "model" (129 ids a rank, the last
    rank's last one a zero pad row / column), d_model over "data" within
    the rank's block."""
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              vocab_size=257, dtype="float32")
    d_model = cfg.d_model
    policy = rules.ShardingPolicy(replicate_small_below=0)
    emb = torch.arange(257 * d_model, dtype=torch.float32).reshape(
        257, d_model) + 1
    tree = dict(rules._whole_meta(cfg), embed=emb, head=emb.T)
    dims = rules.data_cut_dims(cfg, 2, 2, policy)
    assert (dims[0], dims[1]) == (1, 0)        # embed, head: d_model
    n, w = 129, d_model // 2
    for r in range(2):
        real = min(n, 257 - r * n)
        for d in range(2):
            block = rules.shard_for_rank(tree, cfg, 2, r, 2, d, policy)
            want = torch.zeros(n, w)
            want[:real] = emb[r * n:r * n + real, d * w:(d + 1) * w]
            assert torch.equal(block["embed"], want)
            assert torch.equal(block["head"], want.T)


def test_existing_callers_get_the_model_only_tree():
    model = _model("yi-34b")

    def fn(grid):
        a = rules.shard_params(model.params, model.cfg, grid)
        b = rules.shard_params(model.params, model.cfg, grid, data_cut=True,
                               policy=_policy(grid))
        with ambient_grid(grid):
            return ([tuple(x.shape) for x in tree_leaves(a)],
                    rules.tree_cuts(a, model.cfg), rules.tree_cuts(
                        b, model.cfg))

    for shapes, cuts_a, cuts_b in run_local_grid(
            fn, (2, 2), ("data", "model"), "cpu"):
        assert shapes == [tuple(x.shape) for x in tree_leaves(
            rules.shard_for_rank(model.params, model.cfg, 2, 0))]
        assert (cuts_a.model, cuts_a.data) == (2, 1)
        assert (cuts_b.model, cuts_b.data) == (2, 2)
        assert any(d is not None for d in cuts_b.data_dims)


def test_a_data_cut_tree_refuses_the_flat_sync_and_the_paged_route():
    model = _model("yi-34b")
    cfg = model.cfg

    def fn(grid):
        local = rules.shard_params(model.params, cfg, grid, _policy(grid),
                                   data_cut=True)
        errors = []
        with ambient_grid(grid):
            gs = GradSyncConfig(grid=grid, axes=("data",), mode="fsdp")
            try:
                make_train_step(cfg, AdamWConfig(**OPT), grad_sync=gs)(
                    init_train_state(local), _rows(model.tbatch(), 0, 2))
            except ValueError as e:
                errors.append(str(e))
            try:
                forward_paged(local, cfg, init_pages(cfg, 4, 4, device="cpu",
                                                     tp=2),
                              {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
                              torch.ones(1, 1, dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32))
            except NotImplementedError as e:
                errors.append(str(e))
            # a forward without a grad runs, gathering each layer
            with torch.no_grad():
                logits, _ = forward_train(local, cfg, model.tbatch(False))
        return errors, tuple(logits.shape)

    for errors, shape in run_local_grid(fn, (2, 2), ("data", "model"),
                                        "cpu"):
        assert len(errors) == 2
        assert "mode=\"allreduce\"" in errors[0]
        assert "whole over" in errors[1]
        assert shape[:2] == (4, 16)
