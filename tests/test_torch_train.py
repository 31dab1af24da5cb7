"""The port's training path against the JAX package's: the synthetic
data pipeline (bit-identical batches), the learning-rate schedules,
AdamW on the same gradients, and whole train steps of reduced float32
falcon-mamba-7b from the same weights; then the train CLI on the CPU.

Tolerances: schedules 1e-6 relative (float32 arithmetic in both);
AdamW 1e-6 absolute on the same inputs; train steps 1e-5 relative on the
loss and the gradient norm and 1e-5 absolute on the parameters (float32
models whose sums run in other orders; three small steps of Adam).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.state import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.optim import adamw
from repro_torch.train.state import init_train_state
from repro_torch.train.step import (AUX_WEIGHT, cross_entropy,
                                    make_train_step)
from repro_torch.tree import stacked_ndims, tree_leaves
from torch_util import configs, port_params


@pytest.mark.parametrize("shards", [1, 2])
def test_synthetic_batches_are_bit_identical(shards):
    for vocab, seq, batch, seed in [(256, 32, 4, 0), (65024, 64, 2, 3)]:
        for idx in range(shards):
            want = JDataset(JDataConfig(vocab, seq, batch, seed=seed),
                            shards, idx)
            got = SyntheticLMDataset(DataConfig(vocab, seq, batch,
                                                seed=seed), shards, idx)
            for step in (0, 7):
                w, g = want.batch(step), got.batch(step)
                assert set(w) == set(g)
                for k in w:
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "linear",
                                      "constant"])
def test_lr_schedules_match(schedule):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=40, schedule=schedule)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in range(0, 46):
        want = float(jadamw.lr_at(jc, jnp.asarray(step)))
        np.testing.assert_allclose(adamw.lr_at(tc, step), want, rtol=1e-6,
                                   atol=1e-12)


def _tree():
    """A small parameter tree in the reference's stacked layout and as
    the port's per-layer list, with gradients for both."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    stacked = {"embed": f(6, 4), "ln_f": f(4),
               "layers": {"w": f(2, 4, 3), "b": f(2, 3)}}
    grads = {"embed": f(6, 4), "ln_f": f(4),
             "layers": {"w": f(2, 4, 3), "b": f(2, 3)}}

    def port(tree):
        t = torch.from_numpy
        return {"embed": t(tree["embed"].copy()), "ln_f": t(tree["ln_f"]
                                                            .copy()),
                "layers": [{k: t(v[i].copy())
                            for k, v in tree["layers"].items()}
                           for i in range(2)]}
    return stacked, grads, port(stacked), port(grads)


@pytest.mark.parametrize("master", [False, True])
def test_apply_updates_matches_jax(master):
    """Two AdamW steps on the same gradients, with clipping active; decay
    reaches every per-layer leaf, as in the stacked reference."""
    stacked, grads, tp, tg = _tree()
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.5,
              master_weights=master)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, stacked)
    jg = jax.tree.map(jnp.asarray, grads)
    jstate = jadamw.init_state(jp, master)
    tstate = adamw.init_state(tp, master)
    assert stacked_ndims(tp) == [2, 2, 3, 2, 3, 1]
    for _ in range(2):
        jp, jstate, jm = jadamw.apply_updates(jc, jp, jg, jstate)
        tp2, tstate, tm = adamw.apply_updates(tc, tp, tg, tstate)
        assert tp2 is tp                      # updated in place
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert tstate.count == int(jstate.count) == 2
    np.testing.assert_allclose(tp["embed"].numpy(), np.asarray(jp["embed"]),
                               atol=1e-6)
    np.testing.assert_allclose(tp["ln_f"].numpy(), np.asarray(jp["ln_f"]),
                               atol=1e-6)
    for i in range(2):
        for k in ("w", "b"):
            np.testing.assert_allclose(tp["layers"][i][k].numpy(),
                                       np.asarray(jp["layers"][k][i]),
                                       atol=1e-6)
            np.testing.assert_allclose(
                tstate.mu["layers"][i][k].numpy(),
                np.asarray(jstate.mu["layers"][k][i]), atol=1e-6)
    if master:
        np.testing.assert_allclose(tstate.master["ln_f"].numpy(),
                                   np.asarray(jstate.master["ln_f"]),
                                   atol=1e-6)


def test_cross_entropy_matches_jax():
    from repro.train.step import cross_entropy as j_ce
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)
    assert AUX_WEIGHT == 0.01


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    """Three train steps of reduced float32 falcon-mamba-7b (remat on,
    cosine schedule): loss, gradient norm and every parameter after each
    step.  The port runs its CPU route (the chunked scan), as the JAX
    trainer does; the kernel route is held to it in test_torch_ssm.py and
    on the card."""
    jcfg, tcfg = configs("falcon-mamba-7b")
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = port_params(jp, tcfg)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(j_make_step(jcfg, jadamw.AdamWConfig(**kw),
                                microbatches=microbatches))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**kw),
                            microbatches=microbatches)
    jstate, tstate = j_init_state(jp), init_train_state(tp)
    data = SyntheticLMDataset(DataConfig(jcfg.vocab_size, 32, 4))
    for step in range(3):
        b = data.batch(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
    want = port_params(jstate.params, tcfg)
    for got_t, want_t in zip(tree_leaves(tstate.params),
                             tree_leaves(want)):
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(),
                                   rtol=0, atol=1e-5)


def test_train_step_refuses_grad_sync():
    _, tcfg = configs("falcon-mamba-7b")
    with pytest.raises(NotImplementedError, match="A.3"):
        make_train_step(tcfg, adamw.AdamWConfig(), grad_sync=object())


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", "falcon-mamba-7b", "--reduced",
                         "--steps", "3", "--batch", "2", "--seq", "32",
                         "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    out = capsys.readouterr().out
    assert "[train] done: 3 steps of falcon-mamba-7b on cpu" in out


def test_train_cli_defaults_to_cuda_and_refuses_other_families():
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps",
                    "1"])
    with pytest.raises(NotImplementedError, match="dense trainer"):
        train.run("minicpm-2b", 1, 2, 8, device="cpu")
    with pytest.raises(SystemExit):
        train.main(["--arch", "falcon-mamba-7b", "--dp"])
    assert dataclasses.is_dataclass(adamw.AdamWConfig)
