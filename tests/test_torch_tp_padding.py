"""Heads padded to the model axis (``sharding.rules.padded_heads``), the
counterpart of the reference's GSPMD padding of heads that do not divide
the axis (``src/repro/sharding/rules.py:15-17``):

* the padded counts of every config at m 2, 4, 8 and 16 (56 / 8 -> 64 / 8
  at 16; minicpm-2b's 36 / 36 -> 40 / 40 at 8, 48 / 48 at 16; the others
  unchanged), and the shapes that neither cut nor pad still raise;
* reduced float32 configs with the same structure on model-rank threads
  of the CPU, against the JAX package's single-device results from the
  same weights and inputs (``tp_util``): GQA 14 / 2 at m 4 (16 / 2) and
  m 8 (16 / 2: 4 ranks a group), MHA 9 / 9 at m 4 (12 / 12).  Logits and
  loss within 1e-5, gradients gathered by ``unshard_params`` within 1e-4
  of ``jax.grad``, greedy streams identical, the paged route; two AdamW
  steps against the reference's, every pad entry still exactly zero;
* the layout alone at m 8 and 16, on meta tensors: the real
  ``yi-34b`` (and its siblings) and ``minicpm-2b`` shapes for every rank,
  and ``unshard_params`` of ``shard_params`` exact on the same heads at a
  narrow width (16 rank threads).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.state import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.collectives import run_local_grid
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.models import init_params
from repro_torch.models.layers import ambient_grid
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules
from repro_torch.train.state import init_train_state, rank_state_bytes
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves, tree_map
from torch_util import jax_params_numpy
from tp_util import (Model, check_forward, check_grads, check_greedy,
                     check_paged)

GQA = dict(num_heads=14, num_kv_heads=2)
MHA = dict(num_heads=9, num_kv_heads=9)
CASES = [("yi-34b", 4, GQA, (16, 2)), ("minicpm-2b", 4, MHA, (12, 12)),
         ("yi-34b", 8, GQA, (16, 2))]
IDS = ["gqa14_2-m4", "mha9_9-m4", "gqa14_2-m8"]
OPT = dict(warmup_steps=1, total_steps=10)
STEPS = 2
TOL = dict(params=(1e-4, 1e-5), loss=(1e-5, 1e-6))

_MODELS = {}


def _model(arch, kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        _MODELS[key] = Model(arch, **kw)
    return _MODELS[key]


# ------------------------------ the counts ------------------------------ #
@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_padded_heads_of_every_config(arch, m):
    cfg = get_config(arch)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    want = {("yi-34b", 16): (64, 8), ("llava-next-34b", 16): (64, 8),
            ("arctic-480b", 16): (64, 8), ("minicpm-2b", 8): (40, 40),
            ("minicpm-2b", 16): (48, 48)}.get((arch, m), (h, kv))
    assert rules.padded_heads(cfg, m) == want
    rules.exec_layout(cfg, m)                   # every config cuts now


@pytest.mark.parametrize("arch,m,kw,want", CASES, ids=IDS)
def test_padded_heads_of_the_reduced_cases(arch, m, kw, want):
    cfg = _model(arch, kw).cfg
    assert rules.padded_heads(cfg, m) == want


@pytest.mark.parametrize("kw,m,what", [
    (dict(num_heads=12, num_kv_heads=3), 4, "3 kv heads"),
    (dict(num_heads=12, num_kv_heads=6), 4, "6 kv heads"),
])
def test_a_shape_that_neither_cuts_nor_pads_raises(kw, m, what):
    cfg = dataclasses.replace(get_config("yi-34b"), **kw)
    with pytest.raises(ValueError, match=f"the model axis of {m} cannot "
                                         f"cut {what}"):
        rules.exec_layout(cfg, m)


# ------------------- against the reference, reduced ------------------- #
@pytest.mark.parametrize("arch,m,kw,want", CASES, ids=IDS)
def test_forward_and_loss_match_reference(arch, m, kw, want):
    check_forward(_model(arch, kw), m)


@pytest.mark.parametrize("arch,m,kw,want", CASES, ids=IDS)
def test_gradients_match_jax_grad(arch, m, kw, want):
    check_grads(_model(arch, kw), m)


@pytest.mark.parametrize("arch,m,kw,want", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_reference(arch, m, kw, want):
    check_greedy(_model(arch, kw), m)


@pytest.mark.parametrize("arch,m,kw", [("minicpm-2b", 4, MHA),
                                       ("yi-34b", 4, GQA)],
                         ids=["mha9_9-m4", "gqa14_2-m4"])
def test_paged_chunk_and_decode_match_reference(arch, m, kw):
    check_paged(_model(arch, kw), m)


def _pad_entries(local, cfg, m, r):
    """Every pad entry of rank ``r``'s tree: its pad heads' ``wq`` (and,
    padded kv, ``wk`` / ``wv``) columns and ``wo`` rows, by layer."""
    hd = cfg.resolved_head_dim
    out = []
    for lp in local["layers"]:
        for kind, names in (("q", ("wq", "wo")), ("kv", ("wk", "wv"))):
            blk = rules.head_block(cfg, m, r, kind)
            if blk is None or (kind == "kv" and rules._kv_replicated(cfg,
                                                                     m)):
                continue
            _, n_real, n_pad = blk
            for name in names:
                dim = 0 if name == "wo" else 1
                out.append(lp[name].narrow(dim, n_real * hd, n_pad * hd))
    return out


def _reference_steps(model):
    step = jax.jit(j_make_step(model.jcfg, JAdamWConfig(**OPT)))
    st = j_init_state(model.jp)
    ms = []
    for _ in range(STEPS):
        st, metrics = step(st, model.jbatch())
        ms.append(float(metrics["loss"]))
    return params_from_jax(jax_params_numpy(st.params), model.cfg,
                           "cpu"), ms


@pytest.mark.parametrize("arch,m,kw,want", CASES, ids=IDS)
def test_two_adamw_steps_match_reference_and_keep_pads_zero(arch, m, kw,
                                                            want):
    model = _model(arch, kw)
    cfg = model.cfg
    want_params, want_losses = model.memo("ref_steps",
                                          lambda: _reference_steps(model))

    def fn(grid):
        local = tree_map(lambda t: t.clone(),
                         rules.shard_params(model.params, cfg, grid))
        r = grid.axis_index("model")
        pads = _pad_entries(local, cfg, m, r)
        step = make_train_step(cfg, AdamWConfig(**OPT))
        st = init_train_state(local)
        losses = []
        with ambient_grid(grid):
            for _ in range(STEPS):
                st, metrics = step(st, model.tbatch())
                losses.append(float(metrics["loss"]))
        pads = _pad_entries(st.params, cfg, m, r)
        moments = _pad_entries(st.opt.mu, cfg, m, r) + _pad_entries(
            st.opt.nu, cfg, m, r)
        return (rules.unshard_params(st.params, cfg, grid), losses,
                pads, moments)

    out = run_local_grid(fn, (m,), ("model",), "cpu", timeout=120)
    n_pad = 0
    for whole, losses, pads, moments in out:
        for a, b in zip(tree_leaves(whole), tree_leaves(want_params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=TOL["params"][0],
                                       atol=TOL["params"][1])
        np.testing.assert_allclose(losses, want_losses, *TOL["loss"])
        for t in pads + moments:
            assert torch.count_nonzero(t) == 0
        n_pad += len(pads)
    assert n_pad > 0


# ---------------------- the layout at full width ---------------------- #
LAYOUT = [("yi-34b", 16), ("llava-next-34b", 16), ("arctic-480b", 16),
          ("minicpm-2b", 8), ("minicpm-2b", 16)]


@pytest.mark.parametrize("arch,m", LAYOUT,
                         ids=[f"{a}-m{m}" for a, m in LAYOUT])
def test_full_width_rank_shapes_on_meta(arch, m):
    cfg = get_config(arch)
    whole = init_params(cfg, device="meta")
    hp, kvp = rules.padded_heads(cfg, m)
    hd, d = cfg.resolved_head_dim, cfg.d_model
    kv_whole = rules._kv_replicated(cfg, m)
    n_real = 0
    for r in range(m):
        local = rules.shard_for_rank(whole, cfg, m, r)
        for lp in local["layers"]:
            assert lp["wq"].shape == (d, hp // m * hd)
            assert lp["wo"].shape == (hp // m * hd, d)
            kv_cols = cfg.num_kv_heads * hd if kv_whole else kvp // m * hd
            assert lp["wk"].shape == lp["wv"].shape == (d, kv_cols)
        n_real += rules.real_heads(cfg, m, r)
        assert rules.tree_cuts(local, cfg).model == m
    assert n_real == cfg.num_heads
    # a rank's bytes: its padded blocks, all ranks alike
    got = sum(x.numel() * x.element_size()
              for x in tree_leaves(rules.shard_for_rank(whole, cfg, m,
                                                        m - 1)))
    assert got == rank_state_bytes(cfg, m)["params"]


def _narrow(arch):
    """The config's heads at a width the CPU holds: head dim 4, d_model
    64, one layer (arctic 16 experts)."""
    cfg = get_config(arch)
    kw = dict(d_model=64, head_dim=4, d_ff=64, vocab_size=256, num_layers=1)
    if cfg.family == "moe":
        kw.update(num_experts=16, moe_dense_ff=32, d_ff=32)
    return dataclasses.replace(cfg, dtype="float32", **kw)


@pytest.mark.parametrize("arch,m", LAYOUT,
                         ids=[f"{a}-m{m}" for a, m in LAYOUT])
def test_round_trip_is_exact_at_every_rank(arch, m):
    cfg = _narrow(arch)
    params = init_params(cfg, seed=4, device="cpu")

    def fn(grid):
        local = rules.shard_params(params, cfg, grid)
        return rules.unshard_params(local, cfg, grid)

    for back in run_local_grid(fn, (m,), ("model",), "cpu", timeout=120):
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert a.dtype == b.dtype and torch.equal(a, b)
