"""The port's encoder-decoder (whisper-medium's family) against the JAX
package's, on the same weights (moved across as numpy) and inputs: the
frames and tokens are numpy from a seed, as ``jax.random`` cannot be
reproduced in torch (ROADMAP C3).

The reduced config has 2 encoder and 2 decoder layers, d 64, 4 heads x
16, vocab 256.

Tolerances: logits and the encoder's output 1e-4 in float32 and 5e-2 in
bf16 (the same arithmetic in other summation orders); prefill caches
1e-5; gradients 1e-4 of each leaf's max-abs; one AdamW step 1e-5
relative on the loss and gradient norm and 1e-5 absolute on the
parameters, as ``test_torch_dense.py``; the plain non-causal flash 2e-5
against the Pallas kernel in interpret mode and its backward 1e-4 of
each gradient's max-abs against ``jax.grad``, as
``test_torch_head_dims.py``.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.state import init_train_state as j_init_state
from repro.train.step import loss_fn as j_loss_fn
from repro.train.step import make_train_step as j_make_step
from repro_torch.convert import tensor_from_numpy
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, param_specs, prefill)
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step, value_and_grad
from repro_torch.tree import stacked_ndims, stacked_order, tree_leaves
from torch_util import configs, jax_params_numpy, port_params

ARCH = "whisper-medium"
CPU = torch.device("cpu")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def _model(dtype="float32", seed=0):
    jcfg, tcfg = configs(ARCH, dtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, port_params(jp, tcfg)


def _inputs(cfg, b, s_enc, s, seed=1):
    """Frames [b, s_enc, D] (0.02 * normal, as the stub frontend) in the
    activation dtype and tokens [b, s], numpy."""
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(b, s_enc, cfg.d_model)) * 0.02).astype(
        np.float32).astype(jnp.dtype(cfg.dtype))
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return frames, toks


def _batches(frames, toks, labels=None):
    j = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    t = {"frames": _t(frames), "tokens": torch.from_numpy(toks)}
    if labels is not None:
        j["labels"] = jnp.asarray(labels)
        t["labels"] = torch.from_numpy(labels)
    return j, t


# ----------------------------- the tree ------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_param_specs(dtype):
    """The port's own random weights have the reference's tree: the
    encoder and decoder stacks as per-layer lists, ``enc_ln_f`` a leaf;
    every shape and dtype as ``param_specs``; the stacked ranks the
    optimizer's weight decay reads; the parameter count is
    ``param_count()``."""
    jcfg, tcfg = configs(ARCH, dtype)
    specs = jtf.param_specs(jcfg)
    tp = init_params(tcfg, seed=1, device="cpu")
    assert set(tp) == set(specs) == {"embed", "ln_f", "head", "encoder",
                                     "enc_ln_f", "layers"}
    assert len(tp["encoder"]) == tcfg.encoder_layers == 2
    assert len(tp["layers"]) == tcfg.num_layers == 2
    for stack in ("encoder", "layers"):
        for lp in tp[stack]:
            assert set(lp) == set(specs[stack])
            for name, spec in specs[stack].items():
                assert tuple(lp[name].shape) == spec.shape[1:], name
                assert str(lp[name].dtype).split(".")[-1] == \
                    str(spec.dtype), name
    for name in ("embed", "ln_f", "head", "enc_ln_f"):
        assert tuple(tp[name].shape) == specs[name].shape
    # in the reference's stacked order each stacked leaf comes once a
    # layer, with the stack's rank
    nd = stacked_ndims(tp)
    want = [spec.ndim for name in sorted(specs)
            for spec in jax.tree.leaves(specs[name])
            for _ in range(spec.shape[0] if name in ("encoder", "layers")
                           else 1)]
    assert [nd[i] for i in stacked_order(tp)] == want
    n = sum(t.numel() for t in tree_leaves(tp))
    assert n == tcfg.param_count() == sum(s.size for s in
                                          jax.tree.leaves(specs))
    meta = param_specs(tcfg)
    assert [t.shape for t in tree_leaves(meta)] == \
        [t.shape for t in tree_leaves(tp)]


def test_full_width_tree_counts_param_count():
    """At whisper-medium's published widths (meta tensors: nothing
    allocated) the tree holds param_count() = 1.012 B parameters."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    n = sum(t.numel() for t in tree_leaves(param_specs(cfg)))
    assert n == cfg.param_count()
    assert round(n / 1e9, 3) == 1.012


def test_params_from_jax_round_trips():
    """Every converted leaf equals the reference's, bit for bit, in the
    reference's stacked leaf order."""
    _, tcfg, jp, tp = _model("bfloat16")
    want = jax.tree.leaves(jax_params_numpy(jp))
    got = []
    for name in sorted(tp):
        if isinstance(tp[name], list):
            got += [np.stack([_f32(lp[leaf].float()) for lp in tp[name]])
                    for leaf in sorted(tp[name][0])]
        else:
            got.append(_f32(tp[name].float()))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, _f32(w))
    assert tp["encoder"][0]["wq"].dtype == torch.bfloat16


# ---------------------------- the forward ----------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_forward_matches_jax(dtype):
    jcfg, tcfg, jp, tp = _model(dtype)
    frames, _ = _inputs(jcfg, 2, 24, 8)
    want = jtf._encoder_forward(jp, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = ttf._encoder_forward(tp, tcfg, _t(frames), False)
    assert got.dtype == tcfg.activation_dtype
    np.testing.assert_allclose(_f32(got.float()), _f32(want),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_enc", [24, 40])
def test_forward_train_logits_match_jax(dtype, s_enc):
    """Decoder of 16 tokens over 24 frames and over 40 (cross-attention
    with S_enc != S)."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jb, tb = _batches(*_inputs(jcfg, 2, s_enc, 16))
    want, jaux = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch=jb)
    with torch.no_grad():
        got, aux = forward_train(tp, tcfg, tb)
    assert got.shape == (2, 16, tcfg.vocab_size)
    assert got.dtype == torch.float32 and aux == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_forward_train_long_sequence_takes_chunked_attention():
    """S = S_enc = 4096 > 2048: the encoder's self-attention and the
    cross-attention take the non-causal chunked branch, the decoder's
    self-attention the causal one, in both packages; on the CPU the
    port's default and its kernel route both take the plain chunked path
    and launch nothing."""
    jcfg, tcfg, jp, tp = _model("float32")
    jb, tb = _batches(*_inputs(jcfg, 1, 4096, 4096, seed=2))
    want, _ = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch=jb)
    ops.reset_launch_counts()
    with torch.no_grad():
        for use_kernel in (None, True):
            got, _ = forward_train(tp, tcfg, tb, use_kernel=use_kernel)
            np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4,
                                       atol=1e-4)
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def test_loss_gradients_match_jax_grad():
    """One ``loss_fn`` (remat on: every encoder layer checkpointed, each
    decoder layer too): the loss and every gradient leaf against
    ``jax.grad`` of the reference's."""
    jcfg, tcfg, jp, tp = _model("float32")
    frames, toks = _inputs(jcfg, 2, 24, 16, seed=3)
    labels = np.roll(toks, -1, axis=1)
    jb, tb = _batches(frames, toks, labels)
    (jloss, _), jgrads = jax.value_and_grad(
        functools.partial(j_loss_fn, cfg=jcfg, batch=jb), has_aux=True)(jp)
    loss, _, grads = value_and_grad(tp, tcfg, tb)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = port_params(jgrads, tcfg)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err < 1e-4, err


def test_adamw_step_matches_jax():
    """One float32 AdamW step on a batch with frames: loss, gradient norm
    and every parameter (the stacks' norms decay, ``enc_ln_f`` and
    ``ln_f`` do not, in both)."""
    jcfg, tcfg, jp, tp = _model("float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(j_make_step(jcfg, jadamw.AdamWConfig(**kw)))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**kw))
    b = SyntheticLMDataset(DataConfig(jcfg.vocab_size, 32, 2)).batch(0)
    frames, _ = _inputs(jcfg, 2, 32, 1, seed=4)
    jb, tb = _batches(frames, b["tokens"], b["labels"])
    jstate, jm = jstep(j_init_state(jp), jb)
    tstate, tm = tstep(init_train_state(tp), tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    want = port_params(jstate.params, tcfg)
    for got_t, want_t in zip(tree_leaves(tstate.params), tree_leaves(want)):
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=0,
                                   atol=1e-5)


def test_cpu_kernel_route_launches_nothing():
    _, tcfg, _, tp = _model("float32")
    _, tb = _batches(*_inputs(tcfg, 2, 24, 16))
    ops.reset_launch_counts()
    with torch.no_grad():
        forward_train(tp, tcfg, tb, use_kernel=True)
        prefill(tp, tcfg, tb, use_kernel=True)
    assert not any(ops.launch_counts().values())


# ------------------------- prefill and decode ------------------------- #
def test_init_cache_matches_reference():
    jcfg, tcfg = configs(ARCH, "bfloat16")
    want = jtf.init_cache(jcfg, 3, 20, enc_len=12)
    got = init_cache(tcfg, 3, 20, enc_len=12, device="cpu")
    assert set(got) == set(want) == {"k", "v", "enc_k", "enc_v", "pos"}
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
        assert not got[key].any(), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cache_and_logits_match_jax(dtype):
    """The cache is exactly the prompt's length (self K/V) and the
    frames' (cross K/V, no RoPE)."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jb, tb = _batches(*_inputs(jcfg, 2, 24, 12, seed=5))
    jlast, jcache = jtf.prefill(jp, jcfg, jb)
    with torch.no_grad():
        tlast, tcache = prefill(tp, tcfg, tb)
    tol = TOL[dtype]
    np.testing.assert_allclose(tlast.numpy(), _f32(jlast), rtol=tol,
                               atol=tol)
    assert set(tcache) == set(jcache)
    for key in ("k", "v", "enc_k", "enc_v"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(
            _f32(tcache[key].float()), _f32(jcache[key]),
            rtol=1e-5 if dtype == "float32" else tol,
            atol=1e-5 if dtype == "float32" else tol)
    assert tcache["k"].shape[2] == 12 and tcache["enc_k"].shape[2] == 24
    assert int(tcache["pos"]) == int(jcache["pos"]) == 12


def test_decode_after_padding_matches_jax():
    """Prefill, the self cache padded by 8 (the cross cache never is),
    then three greedy decode steps from each package's own cache."""
    jcfg, tcfg, jp, tp = _model("float32")
    jb, tb = _batches(*_inputs(jcfg, 2, 24, 12, seed=6))
    jlast, jcache = jtf.prefill(jp, jcfg, jb)
    with torch.no_grad():
        tlast, tcache = prefill(tp, tcfg, tb)
    pad = [(0, 0), (0, 0), (0, 8), (0, 0), (0, 0)]
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad),
                  v=jnp.pad(jcache["v"], pad))
    tcache = dict(tcache, **{k: torch.nn.functional.pad(
        tcache[k], (0, 0, 0, 0, 0, 8)) for k in ("k", "v")})
    j_decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    for _ in range(3):
        nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
        jlast, jcache = j_decode(jp, cache=jcache,
                                 batch={"tokens": jnp.asarray(nxt)})
        with torch.no_grad():
            tlast, tcache = decode_step(tp, tcfg, tcache,
                                        {"tokens": torch.from_numpy(nxt)})
        np.testing.assert_allclose(tlast.numpy(), _f32(jlast), rtol=1e-4,
                                   atol=1e-4)
    for key in ("k", "v", "enc_k", "enc_v"):
        np.testing.assert_allclose(tcache[key].numpy(), _f32(jcache[key]),
                                   rtol=1e-5, atol=1e-5)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 15


def test_decode_follows_forward_train():
    """The reference's ``test_encdec_prefill_matches_forward`` (prefill's
    last logits equal the teacher-forced forward's), plus decode steps:
    each step's logits equal the forward's at its position, over the same
    frames (chip_smoke.py makes this check on the card)."""
    jcfg, tcfg, jp, tp = _model("float32")
    frames, seq = _inputs(jcfg, 2, 24, 14, seed=7)
    _, tb = _batches(frames, seq)
    jfull, _ = jtf.forward_train(jp, jcfg, {"frames": jnp.asarray(frames),
                                            "tokens": jnp.asarray(seq)})
    with torch.no_grad():
        full, _ = forward_train(tp, tcfg, tb)
        np.testing.assert_allclose(full.numpy(), _f32(jfull), rtol=1e-4,
                                   atol=1e-4)
        last, cache = prefill(tp, tcfg, dict(tb, tokens=tb["tokens"][:, :8]))
        cache = dict(cache, **{k: torch.nn.functional.pad(
            cache[k], (0, 0, 0, 0, 0, 8)) for k in ("k", "v")})
        steps = [last]
        for t in range(8, 14):
            last, cache = decode_step(tp, tcfg, cache,
                                      {"tokens": tb["tokens"][:, t:t + 1]})
            steps.append(last)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 7:], rtol=1e-4,
                               atol=1e-4)


# ------------------------------- the CLI ------------------------------ #
def test_train_cli_trains_whisper_on_cpu(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--reduced", "--steps", "5",
                         "--batch", "4", "--seq", "64", "--device", "cpu"])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert f"[train] done: 5 steps of {ARCH} on cpu" in out
    with pytest.raises(SystemExit, match="--moe-ep needs an MoE "
                       "architecture; whisper-medium is family='encdec'"):
        train.main(["--arch", ARCH, "--reduced", "--moe-ep", "--device",
                    "cpu"])


def test_cli_batch_carries_frames():
    """``build_batch`` adds frames [B, S, D] in the activation dtype, the
    same for one (seed, step) and other for another step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config(ARCH).reduced()
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, 16, 3))
    b0 = train.build_batch(cfg, data.batch(0),
                           train.step_generator(0, 0, "cpu"), "cpu")
    again = train.build_batch(cfg, data.batch(0),
                              train.step_generator(0, 0, "cpu"), "cpu")
    b1 = train.build_batch(cfg, data.batch(1),
                           train.step_generator(0, 1, "cpu"), "cpu")
    assert set(b0) == {"tokens", "labels", "frames"}
    assert b0["frames"].shape == (3, 16, cfg.d_model)
    assert b0["frames"].dtype == cfg.activation_dtype
    assert torch.equal(b0["frames"], again["frames"])
    assert not torch.equal(b0["frames"], b1["frames"])
    assert 0.01 < float(b0["frames"].float().std()) < 0.03


# --------------------- the flash kernel, non-causal ------------------- #
def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def test_plain_flash_noncausal_at_head_dim_64_matches_pallas_interpret():
    """Whisper's encoder and cross-attention shape cut down: MHA 4/4, D
    64, non-causal, no window, over S 256."""
    q, k, v = _qkv(1, 4, 4, 256, 64, seed=64)
    got, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=False, window=None)
    want = pallas_flash(q, k, v, causal=False, window=None, block_q=64,
                        block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert lse.shape == (1, 4, 256) and torch.isfinite(lse).all()


def test_plain_flash_backward_noncausal_matches_jax_grad():
    b, h, hkv, s, d = 1, 4, 4, 256, 64
    q, k, v = _qkv(b, h, hkv, s, d, seed=9)
    do = np.random.default_rng(10).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        o = jl._chunked_attention(q_, k_, v_, False, None, chunk=64)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash_attention_ref(tq, tk, tv, False, None)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  False, None)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (name, err)


# ------------------------------ gelu_mlp ------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """The reference exports ``gelu_mlp`` (tanh GELU, biased); no model
    path runs it, in either package."""
    rng = np.random.default_rng(11)
    arrs = [rng.normal(size=shape).astype(np.float32) * scale
            for shape, scale in (((2, 5, 16), 1.0), ((16, 32), 0.25),
                                 ((32,), 0.1), ((32, 16), 0.18),
                                 ((16,), 0.1))]
    arrs = [a.astype(jnp.dtype(dtype)) for a in arrs]
    want = jl.gelu_mlp(*map(jnp.asarray, arrs))
    got = tl.gelu_mlp(*map(_t, arrs))
    assert str(got.dtype).split(".")[-1] == dtype
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_f32(got.float()), _f32(want), rtol=tol,
                               atol=tol)
    assert "gelu_mlp" in tl.__all__

