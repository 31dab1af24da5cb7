"""Shared helpers of the tensor-parallel block tests
(``test_torch_tp_block_*.py``): the reference's single-device results of
a reduced float32 config, and the port's sharded route on ``model``
rank threads of the CPU, from the same weights and inputs.

Tolerances: logits and loss 1e-5, gradients 1e-4 (the same float32
arithmetic, each row-parallel product summed over m partial products),
greedy streams identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import paged as jpaged
from repro.models import transformer as jtf
from repro.train import step as jstep
from repro_torch.collectives import run_local_grid
from repro_torch.convert import params_from_jax
from repro_torch.models import decode_step, forward_train, prefill
from repro_torch.models.layers import ambient_grid
from repro_torch.models.paged import forward_paged, init_pages
from repro_torch.models.transformer import local_kv_heads
from repro_torch.sharding.rules import (for_grid, shard_params,
                                        unshard_params)
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves
from torch_util import configs, jax_params_numpy

LOGITS_TOL = 1e-5
GRAD_TOL = 1e-4
B = 2
#: prompt length by family (the hybrid's a multiple of its window, where
#: the reference's ring and the port's agree: ROADMAP C25)
PROMPT = {"hybrid": 32}
DECODE_STEPS = 4
HEADROOM = DECODE_STEPS


class Model:
    """A reduced float32 config's weights in both packages and one batch
    of inputs (numpy, from a seed)."""

    def __init__(self, arch, seed=0, batch=B, **overrides):
        self.jcfg, self.cfg = (dataclasses.replace(c, **overrides)
                               for c in configs(arch, "float32"))
        self.jp = jtf.init_params(jax.random.PRNGKey(seed), self.jcfg)
        self.np_params = jax_params_numpy(self.jp)
        self.params = params_from_jax(self.np_params, self.cfg, "cpu")
        self._memo = {}
        s = PROMPT.get(self.cfg.family, 16)
        rng = np.random.default_rng(seed + 1)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (batch, s)).astype(np.int32)
        self.batch = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
        if self.cfg.family == "encdec":
            self.batch["frames"] = rng.normal(
                size=(batch, 16, self.cfg.d_model)).astype(np.float32)
        if self.cfg.frontend == "vision":
            self.batch["soft_emb"] = rng.normal(
                size=(batch, 4, self.cfg.d_model)).astype(np.float32)

    def memo(self, name, fn):
        """``fn()`` once per model (the reference's results are shared by
        the cases at m 2 and 4)."""
        if name not in self._memo:
            self._memo[name] = fn()
        return self._memo[name]

    def jbatch(self, labels=True):
        return {k: jnp.asarray(v) for k, v in self.batch.items()
                if labels or k != "labels"}

    def tbatch(self, labels=True):
        return {k: torch.from_numpy(v) for k, v in self.batch.items()
                if labels or k != "labels"}

    # ---------------------------- reference ---------------------------- #
    def ref_forward(self):
        """(logits, loss) of the reference's single-device step."""
        logits, _ = jtf.forward_train(self.jp, self.jcfg,
                                      self.jbatch(False), remat=False)
        loss, _ = jstep.loss_fn(self.jp, self.jcfg, self.jbatch())
        return np.asarray(logits), float(loss)

    def ref_grads(self):
        """``jax.grad`` of the reference's loss, as the port's tree."""
        grads = jax.grad(lambda p: jstep.loss_fn(p, self.jcfg,
                                                 self.jbatch())[0])(self.jp)
        return params_from_jax(jax_params_numpy(grads), self.cfg, "cpu")

    def ref_greedy(self):
        """(tokens, logits of every step) of the reference's prefill and
        greedy decode steps."""
        logits, cache = jtf.prefill(self.jp, self.jcfg, self.jbatch(False))
        cache = pad_cache(self.cfg, cache, jnp)
        steps, toks = [np.asarray(logits)], []
        for _ in range(DECODE_STEPS):
            nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(nxt))
            logits, cache = jtf.decode_step(self.jp, self.jcfg, cache,
                                            {"tokens": nxt})
            steps.append(np.asarray(logits))
        return np.concatenate(toks, 1), np.concatenate(steps, 1)

    def ref_paged(self):
        """The reference's paged prefill chunk and decode step logits."""
        pages = jpaged.init_pages(self.jcfg, PAGED["blocks"],
                                  PAGED["block_size"])
        bt, ctx, toks = paged_inputs(self.batch["tokens"])
        l1, pages = jpaged.forward_paged(
            self.jp, self.jcfg, pages, {"tokens": jnp.asarray(toks[0])},
            jnp.asarray(bt), jnp.asarray(ctx))
        l2, _ = jpaged.forward_paged(
            self.jp, self.jcfg, pages, {"tokens": jnp.asarray(toks[1])},
            jnp.asarray(bt), jnp.asarray(ctx + toks[0].shape[1]))
        return np.concatenate([np.asarray(l1), np.asarray(l2)], 1)

    # ------------------------- the sharded port ------------------------ #
    def on_ranks(self, fn, m, n=1):
        """``fn(grid, rank's tree)`` on ``m`` model-rank threads under the
        ambient grid, or with ``n`` > 1 on a (data n, model m) grid, the
        tree cut over "data" too (every leaf the spec puts "data" on: the
        reduced configs' leaves are all below ``replicate_small_below``);
        the results by rank, row-major over (data, model)."""
        def rank(grid):
            if n == 1:
                local = shard_params(self.params, self.cfg, grid)
            else:
                policy = dataclasses.replace(for_grid(grid),
                                             replicate_small_below=0)
                local = shard_params(self.params, self.cfg, grid, policy,
                                     data_cut=True)
            with ambient_grid(grid):
                return fn(grid, local)
        if n == 1:
            return run_local_grid(rank, (m,), ("model",), "cpu",
                                  timeout=120)
        return run_local_grid(rank, (n, m), ("data", "model"), "cpu",
                              timeout=300)

    def tp_forward(self, m):
        """Per rank: (logits gathered over the padded vocabulary, the pad
        columns dropped, loss)."""
        def fn(grid, local):
            logits, _ = forward_train(local, self.cfg, self.tbatch(False),
                                      remat=False)
            loss, _, _ = value_and_grad(local, self.cfg, self.tbatch())
            parts = grid.sub("model").all_gather(logits[None])
            whole = torch.cat(list(parts), -1)[..., :self.cfg.vocab_size]
            return whole.numpy(), float(loss)
        return self.on_ranks(fn, m)

    def tp_grads(self, m):
        """Per rank: the gradients of the rank's tree, gathered whole."""
        def fn(grid, local):
            _, _, grads = value_and_grad(local, self.cfg, self.tbatch())
            return unshard_params(grads, self.cfg, grid)
        return self.on_ranks(fn, m)

    def tp_greedy(self, m, n=1):
        """Per rank: (tokens, logits of every step) of prefill and greedy
        decode on the rank's tree (:meth:`on_ranks`), of its data rank's
        rows of the batch."""
        def fn(grid, local):
            batch = self.tbatch(False)
            if n > 1:
                per = len(self.batch["tokens"]) // n
                d = grid.axis_index("data")
                batch = {k: v[d * per:(d + 1) * per]
                         for k, v in batch.items()}
            with torch.no_grad():
                logits, cache = prefill(local, self.cfg, batch)
                cache = pad_cache(self.cfg, cache, torch)
                steps, toks = [logits], []
                for _ in range(DECODE_STEPS):
                    nxt = logits[:, -1].argmax(-1, keepdim=True).int()
                    toks.append(nxt)
                    logits, cache = decode_step(local, self.cfg, cache,
                                                {"tokens": nxt})
                    steps.append(logits)
            return torch.cat(toks, 1).numpy(), torch.cat(steps, 1).numpy()
        return self.on_ranks(fn, m, n)

    def tp_paged(self, m):
        """Per rank: the paged chunk and decode step logits on the rank's
        tree and pool (the decode step through the kernel route)."""
        bt, ctx, toks = paged_inputs(self.batch["tokens"])

        def fn(grid, local):
            pages = init_pages(self.cfg, PAGED["blocks"],
                               PAGED["block_size"], device="cpu", tp=m)
            assert pages["k"].shape[3] == local_kv_heads(self.cfg, m)
            with torch.no_grad():
                l1, pages = forward_paged(
                    local, self.cfg, pages,
                    {"tokens": torch.from_numpy(toks[0])},
                    torch.from_numpy(bt), torch.from_numpy(ctx))
                l2, _ = forward_paged(
                    local, self.cfg, pages,
                    {"tokens": torch.from_numpy(toks[1])},
                    torch.from_numpy(bt),
                    torch.from_numpy(ctx + toks[0].shape[1]),
                    use_kernel=True)
            return torch.cat([l1, l2], 1).numpy()
        return self.on_ranks(fn, m)


PAGED = dict(blocks=16, block_size=4)


def paged_inputs(tokens):
    """Block tables (rows 1-6 and 7-12 of the pool), zero context, and the
    prompt split into a prefill chunk and one decode token."""
    bt = np.arange(1, 1 + B * 6, dtype=np.int32).reshape(B, 6)
    ctx = np.zeros(B, np.int32)
    s = tokens.shape[1]
    return bt, ctx, (tokens[:, :s - 1], tokens[:, s - 1:])


def pad_cache(cfg, cache, xp):
    """Decode headroom for the dense and the encoder-decoder's self K/V
    (their prefill cache is exactly the prompt)."""
    if cfg.family not in ("dense", "moe", "encdec"):
        return cache
    if xp is torch:
        pad = (0, 0, 0, 0, 0, HEADROOM)
        return dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                    v=torch.nn.functional.pad(cache["v"], pad))
    widths = [(0, 0)] * 5
    widths[2] = (0, HEADROOM)
    return dict(cache, k=jnp.pad(cache["k"], widths),
                v=jnp.pad(cache["v"], widths))


def assert_close_trees(got, want, tol):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol)


def check_forward(model, m):
    want_logits, want_loss = model.memo("ref_forward", model.ref_forward)
    for logits, loss in model.tp_forward(m):
        np.testing.assert_allclose(logits, want_logits, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
        np.testing.assert_allclose(loss, want_loss, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)


def check_grads(model, m):
    want = model.memo("ref_grads", model.ref_grads)
    for grads in model.tp_grads(m):
        assert_close_trees(grads, want, GRAD_TOL)


def check_greedy(model, m, n=1):
    """Every rank's greedy stream against the reference's on its rows;
    ``n`` > 1: the tree cut over a data axis of ``n`` too."""
    want_toks, want_logits = model.memo("ref_greedy", model.ref_greedy)
    per = len(want_toks) // n
    for r, (toks, logits) in enumerate(model.tp_greedy(m, n)):
        rows = slice((r // m) * per, (r // m + 1) * per)
        np.testing.assert_array_equal(toks, want_toks[rows])
        np.testing.assert_allclose(logits, want_logits[rows],
                                   rtol=LOGITS_TOL, atol=LOGITS_TOL)


def check_paged(model, m):
    want = model.memo("ref_paged", model.ref_paged)
    for logits in model.tp_paged(m):
        np.testing.assert_allclose(logits, want, rtol=LOGITS_TOL,
                                   atol=LOGITS_TOL)
