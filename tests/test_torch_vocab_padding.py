"""A vocabulary padded to the model axis (``sharding.rules.padded_vocab``),
the counterpart of the reference's GSPMD padding of a vocabulary that does
not divide the axis (``src/repro/sharding/rules.py:15-17``, logits kept as
``P(dp, None, "model")``):

* the padded vocabulary of every config at m 2, 4, 8 and 16 (minicpm-2b
  122753 -> 122754 / 122756 / 122760 / 122768, whisper-medium 51865 ->
  51866 / 51868 / 51872 / 51872, the others unchanged), the embedding and
  the head vocab-parallel at every m;
* reduced float32 dense and encoder-decoder configs (one layer) with the
  odd vocabularies 257 (m 2 and 4) and 261 (m 4) on model-rank threads
  of the CPU, against the JAX package's single-device results from the
  same weights and inputs (``tp_util``): a rank's ``forward_train`` block
  is [B, S, Vp / m] (pad columns 0), the gathered logits and the loss
  within 1e-5, the gradients gathered by ``unshard_params`` within 1e-4
  of ``jax.grad``, prefill + greedy decode (whole [..., V] logits,
  identical tokens, logits within 1e-5), the dense paged route; two
  AdamW steps of each config on a (data 2, model 2) grid, whole over
  "data" and cut over it, against the reference's step, the pad rows and
  columns (and their moments) exactly zero afterwards;
* the vocab-parallel cross entropy where every real logit is below -30,
  so an unmasked zero pad column would move the loss: the one-rank loss
  within 1e-6 and a pad column's gradient exactly zero;
* ``shard_params`` -> ``unshard_params`` bitwise; the dry-run of
  ``minicpm-2b`` train_4k on both production grids fits one H100, and its
  ``padding`` record carries the vocabulary.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import paged as jpaged
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import step as jstep
from repro.train.state import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.collectives import run_local_grid
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun
from repro_torch.models import forward_train, init_params
from repro_torch.models.layers import ambient_grid
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules
from repro_torch.train.state import init_train_state
from repro_torch.train.step import (GradSyncConfig, cross_entropy,
                                    make_train_step, value_and_grad)
from repro_torch.tree import tree_leaves, tree_map
from torch_util import jax_params_numpy
from tp_util import (DECODE_STEPS, LOGITS_TOL, PAGED, Model,
                     assert_close_trees, check_greedy, check_paged,
                     pad_cache, paged_inputs)

DENSE, ENCDEC = "minicpm-2b", "whisper-medium"
CASES = [(a, v, m) for a in (DENSE, ENCDEC)
         for v, m in ((257, 2), (257, 4), (261, 4))]
IDS = [f"{'dense' if a == DENSE else 'encdec'}-v{v}-m{m}"
       for a, v, m in CASES]
#: the forward and gradient cases: the encoder-decoder at V 257, m 2 is
#: held through its loss and its parameters after two AdamW steps
#: (``test_two_adamw_steps_on_a_data_model_grid_keep_pads_zero``)
GRAD_CASES = [(c, i) for c, i in zip(CASES, IDS) if i != "encdec-v257-m2"]
GRAD_TOL = 1e-4
OPT = dict(warmup_steps=1, total_steps=10)
STEPS = 2
TOL = dict(params=(1e-4, 1e-5), loss=(1e-5, 1e-6))

_MODELS = {}


class _Model(Model):
    """``tp_util.Model`` with the reference's results from ``jax.jit``
    (one compile for the logits, the loss and the gradients, one for each
    of prefill, the decode step and the paged step): the same arithmetic
    as the eager calls at a fraction of their cost."""

    def _value_and_grad(self):
        def run():
            def f(p, batch):
                inputs = {k: v for k, v in batch.items() if k != "labels"}
                logits, _ = jtf.forward_train(p, self.jcfg, inputs,
                                              remat=False)
                return jstep.loss_fn(p, self.jcfg, batch)[0], logits
            (loss, logits), grads = jax.jit(jax.value_and_grad(
                f, has_aux=True))(self.jp, self.jbatch())
            return np.asarray(logits), float(loss), grads
        return self.memo("ref_value_and_grad", run)

    def ref_forward(self):
        logits, loss, _ = self._value_and_grad()
        return logits, loss

    def ref_grads(self):
        grads = self._value_and_grad()[2]
        return params_from_jax(jax_params_numpy(grads), self.cfg, "cpu")

    def ref_greedy(self):
        prefill = jax.jit(lambda p, b: jtf.prefill(p, self.jcfg, b))
        decode = jax.jit(lambda p, c, b: jtf.decode_step(p, self.jcfg, c,
                                                         b))
        logits, cache = prefill(self.jp, self.jbatch(False))
        cache = pad_cache(self.cfg, cache, jnp)
        steps, toks = [np.asarray(logits)], []
        for _ in range(DECODE_STEPS):
            nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(nxt))
            logits, cache = decode(self.jp, cache, {"tokens": nxt})
            steps.append(np.asarray(logits))
        return np.concatenate(toks, 1), np.concatenate(steps, 1)

    def ref_paged(self):
        step = jax.jit(lambda p, pages, b, bt, ctx: jpaged.forward_paged(
            p, self.jcfg, pages, b, bt, ctx))
        pages = jpaged.init_pages(self.jcfg, PAGED["blocks"],
                                  PAGED["block_size"])
        bt, ctx, toks = paged_inputs(self.batch["tokens"])
        out = []
        for t in toks:
            logits, pages = step(self.jp, pages, {"tokens": jnp.asarray(t)},
                                 jnp.asarray(bt), jnp.asarray(ctx))
            out.append(np.asarray(logits))
            ctx = ctx + t.shape[1]
        return np.concatenate(out, 1)


def _model(arch, vocab):
    """The reduced config at ``vocab`` words, one layer (one encoder and
    one decoder layer): the padding lives in the embedding and the
    head."""
    key = (arch, vocab)
    if key not in _MODELS:
        depth = dict(num_layers=1)
        if arch == ENCDEC:
            depth["encoder_layers"] = 1
        _MODELS[key] = _Model(arch, vocab_size=vocab, **depth)
    return _MODELS[key]


# ------------------------------ the counts ------------------------------ #
@pytest.mark.parametrize("m", [2, 4, 8, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_padded_vocab_of_every_config(arch, m):
    cfg = get_config(arch)
    want = {(DENSE, 2): 122754, (DENSE, 4): 122756, (DENSE, 8): 122760,
            (DENSE, 16): 122768, (ENCDEC, 2): 51866, (ENCDEC, 4): 51868,
            (ENCDEC, 8): 51872, (ENCDEC, 16): 51872}.get(
                (arch, m), cfg.vocab_size)
    assert rules.padded_vocab(cfg, m) == want
    assert rules.padded_vocab(cfg, 1) == cfg.vocab_size
    layout = rules.exec_layout(cfg, m)
    assert (layout["embed"], layout["head"]) == (0, 1)
    n = want // m
    blocks = [rules.vocab_block(cfg, m, r) for r in range(m)]
    assert [b[0] for b in blocks] == [r * n for r in range(m)]
    assert sum(b[1] for b in blocks) == cfg.vocab_size
    assert all(b[1] + b[2] == n for b in blocks)


# ------------------- against the reference, reduced ------------------- #
def _tp_train_results(model, m):
    """Per rank, memoised: (its forward_train block, the blocks gathered
    without the pad columns, the loss, the gradients gathered whole)."""
    cfg = model.cfg

    def run():
        def fn(grid, local):
            logits, _ = forward_train(local, cfg, model.tbatch(False),
                                      remat=False)
            loss, _, grads = value_and_grad(local, cfg, model.tbatch())
            parts = grid.sub("model").all_gather(logits[None])
            whole = torch.cat(list(parts), -1)[..., :cfg.vocab_size]
            return (logits.numpy(), whole.numpy(), float(loss),
                    rules.unshard_params(grads, cfg, grid))
        return model.on_ranks(fn, m)
    return model.memo(("tp_train", m), run)


@pytest.mark.parametrize("arch,vocab,m", [c for c, _ in GRAD_CASES],
                         ids=[i for _, i in GRAD_CASES])
def test_forward_and_loss_match_reference(arch, vocab, m):
    model = _model(arch, vocab)
    want_logits, want_loss = model.memo("ref_forward", model.ref_forward)
    vp = rules.padded_vocab(model.cfg, m)
    assert vp % m == 0 and vp > vocab
    for r, (block, whole, loss, _) in enumerate(_tp_train_results(model,
                                                                  m)):
        assert block.shape == want_logits.shape[:-1] + (vp // m,)
        _, real, pad = rules.vocab_block(model.cfg, m, r)
        assert not block[..., real:].any()       # a pad column's logit
        np.testing.assert_allclose(whole, want_logits, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        np.testing.assert_allclose(loss, want_loss, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)


@pytest.mark.parametrize("arch,vocab,m", [c for c, _ in GRAD_CASES],
                         ids=[i for _, i in GRAD_CASES])
def test_gradients_match_jax_grad(arch, vocab, m):
    model = _model(arch, vocab)
    want = model.memo("ref_grads", model.ref_grads)
    for *_, grads in _tp_train_results(model, m):
        assert grads["embed"].shape == (vocab, model.cfg.d_model)
        assert_close_trees(grads, want, GRAD_TOL)


@pytest.mark.parametrize("arch,vocab,m", CASES, ids=IDS)
def test_prefill_and_greedy_decode_match_reference(arch, vocab, m):
    """Whole [..., V] logits on every rank, as the reference's."""
    model = _model(arch, vocab)
    want_toks, want_logits = model.memo("ref_greedy", model.ref_greedy)
    assert want_logits.shape[-1] == vocab
    check_greedy(model, m)


@pytest.mark.parametrize("vocab,m", [(257, 2), (257, 4), (261, 4)],
                         ids=["v257-m2", "v257-m4", "v261-m4"])
def test_paged_chunk_and_decode_match_reference(vocab, m):
    check_paged(_model(DENSE, vocab), m)


def _pad_entries(tree, cfg, m, r):
    """Rank ``r``'s pad rows of ``embed`` and pad columns of ``head``."""
    _, real, pad = rules.vocab_block(cfg, m, r)
    return [tree["embed"].narrow(0, real, pad),
            tree["head"].narrow(1, real, pad)]


def _reference_steps(model):
    step = jax.jit(j_make_step(model.jcfg, JAdamWConfig(**OPT)))
    st = j_init_state(model.jp)
    ms = []
    for _ in range(STEPS):
        st, metrics = step(st, model.jbatch())
        ms.append(float(metrics["loss"]))
    return params_from_jax(jax_params_numpy(st.params), model.cfg,
                           "cpu"), ms


@pytest.mark.parametrize("arch,data_cut",
                         [(DENSE, False), (DENSE, True), (ENCDEC, False),
                          (ENCDEC, True)],
                         ids=["dense", "dense-data_cut", "encdec",
                              "encdec-data_cut"])
def test_two_adamw_steps_on_a_data_model_grid_keep_pads_zero(arch,
                                                             data_cut):
    """(data 2, model 2), the vocabulary 257 padded to 258 (rank 1's last
    id a pad id); each data rank its row of the batch; with ``data_cut``
    the tree cut over "data" too (d_model within the vocabulary block)."""
    model = _model(arch, 257)
    cfg = model.cfg
    want_params, want_losses = model.memo("ref_steps",
                                          lambda: _reference_steps(model))

    def fn(grid):
        policy = dataclasses.replace(rules.for_grid(grid),
                                     replicate_small_below=0)
        local = tree_map(lambda t: t.clone(), rules.shard_params(
            model.params, cfg, grid, policy, data_cut=data_cut))
        r, d = grid.axis_index("model"), grid.axis_index("data")
        gs = GradSyncConfig(grid=grid, axes=("data",), mode="allreduce")
        step = make_train_step(cfg, AdamWConfig(**OPT), grad_sync=gs)
        st = init_train_state(local)
        rows = {k: v[d:d + 1] for k, v in model.tbatch().items()}
        losses = []
        with ambient_grid(grid):
            for _ in range(STEPS):
                st, metrics = step(st, rows)
                losses.append(float(metrics["loss"]))
        pads = [t for tree in (st.params, st.opt.mu, st.opt.nu)
                for t in _pad_entries(tree, cfg, 2, r)]
        return rules.unshard_params(st.params, cfg, grid), losses, pads

    out = run_local_grid(fn, (2, 2), ("data", "model"), "cpu", timeout=300)
    n_pad = 0
    for whole, losses, pads in out:
        for a, b in zip(tree_leaves(whole), tree_leaves(want_params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=TOL["params"][0],
                                       atol=TOL["params"][1])
        np.testing.assert_allclose(losses, want_losses, *TOL["loss"])
        for t in pads:
            assert torch.count_nonzero(t) == 0
            n_pad += t.numel()
    assert n_pad > 0


# ----------------------------- cross entropy ----------------------------- #
@pytest.mark.parametrize("vocab,m", [(261, 4), (5, 4)],
                         ids=["v261-m4", "v5-m4-a_rank_all_pad"])
def test_cross_entropy_leaves_the_pad_columns_out(vocab, m):
    """Real logits all below -30: a zero pad column would dominate the
    sum of exponentials.  Each rank's block is its real columns, then
    zeros, as the head's zero pad columns give; at V 5, m 4 the last
    rank holds pad ids only."""
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.uniform(-40.0, -31.0, (2, 3, vocab)))
    labels = torch.from_numpy(rng.integers(0, vocab, (2, 3)))
    want = float(cross_entropy(logits, labels))
    vp = -(-vocab // m) * m
    padded = torch.cat([logits, logits.new_zeros(2, 3, vp - vocab)], -1)
    n = vp // m
    unmasked = float(cross_entropy(padded, labels))
    assert abs(unmasked - want) > 1.0       # the zero column's weight

    def fn(grid):
        r = grid.axis_index("model")
        block = padded[..., r * n:(r + 1) * n].clone().requires_grad_()
        loss = cross_entropy(block, labels, grid.sub("model"), vocab)
        (grad,) = torch.autograd.grad(loss, block)
        real = min(n, max(0, vocab - r * n))
        return float(loss.detach()), grad[..., real:], grad[..., :real]

    for loss, pad_grad, real_grad in run_local_grid(fn, (m,), ("model",),
                                                    "cpu"):
        assert abs(loss - want) <= 1e-6
        assert torch.count_nonzero(pad_grad) == 0
        assert torch.isfinite(real_grad).all()


# ------------------------------ the layout ------------------------------ #
@pytest.mark.parametrize("arch,vocab,m", CASES, ids=IDS)
def test_rank_trees_join_back_bitwise(arch, vocab, m):
    cfg = dataclasses.replace(get_config(arch).reduced(), vocab_size=vocab,
                              dtype="float32")
    params = init_params(cfg, seed=5, device="cpu")

    def fn(grid):
        local = rules.shard_params(params, cfg, grid)
        assert rules.tp_degree(local, cfg) == m
        vp = rules.padded_vocab(cfg, m)
        assert local["embed"].shape == (vp // m, cfg.d_model)
        assert local["head"].shape == (cfg.d_model, vp // m)
        return rules.unshard_params(local, cfg, grid)

    for back in run_local_grid(fn, (m,), ("model",), "cpu"):
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_data_cut_tree_joins_back_bitwise():
    cfg = dataclasses.replace(get_config(DENSE).reduced(), vocab_size=261,
                              dtype="float32")
    params = init_params(cfg, seed=6, device="cpu")

    def fn(grid):
        policy = dataclasses.replace(rules.for_grid(grid),
                                     replicate_small_below=0)
        local = rules.shard_params(params, cfg, grid, policy, data_cut=True)
        # 262 ids: 131 a model rank, its d_model halved over "data"
        assert local["embed"].shape == (131, cfg.d_model // 2)
        assert local["head"].shape == (cfg.d_model // 2, 131)
        with ambient_grid(grid):
            assert rules.tree_cuts(local, cfg).data == 2
        return rules.unshard_params(local, cfg, grid)

    for back in run_local_grid(fn, (2, 2), ("data", "model"), "cpu"):
        for a, b in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b)


# ------------------------------- sizing ------------------------------- #
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_minicpm_train_4k_fits_one_h100_on_the_production_grid(mesh):
    rec = dryrun.run_cell(DENSE, "train_4k", mesh, save=False)
    assert rec["status"] == "ok", rec
    assert rec["fits"], rec["memory"]
    pad = rec["padding"]
    assert (pad["vocab"], pad["padded_vocab"]) == (122753, 122768)
    assert pad["heads"] == [36, 36] and pad["padded_heads"] == [48, 48]


def test_padding_record_carries_the_vocabulary():
    shape = SHAPES["train_4k"]
    rec = dryrun.padding_record(get_config(ENCDEC), shape, 8)
    assert (rec["vocab"], rec["padded_vocab"], rec["model_axis"]) == (
        51865, 51872, 8)
    assert rec["pad_vocab_flops_share"] == pytest.approx(7 / 51872)
    assert rec["pad_vocab_bytes_share"] == pytest.approx(7 / 51872)
    assert rec["pad_flops_share"] == 0.0        # 16 heads divide 8
    ssm = dryrun.padding_record(get_config("falcon-mamba-7b"), shape, 16)
    assert ssm["padded_vocab"] == ssm["vocab"] == 65024
    assert ssm["pad_vocab_flops_share"] == 0.0 and "heads" not in ssm
