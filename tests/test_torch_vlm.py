"""The port's vision soft tokens (``llava-next-34b``'s backbone) against
the JAX package's, on the same weights (moved across as numpy) and the
same soft tokens (numpy from a seed: ``jax.random`` cannot be reproduced
in torch, ROADMAP C3).

The reduced config has 2 layers, d 64, 4/2 heads x 16, vocab 256 and 8
soft tokens.  Covered: ``_embed``, ``forward_train`` (short, and 8 + 4088
positions on the chunked branch), ``prefill`` and padded ``decode_step``;
``forward_paged`` with the soft tokens on the first chunk at chunks 8
and 12, against the reference and against the dense cache; the server's
greedy streams against the reference server's, on one server and on a
2-rank thread grid; the trainer's step with soft tokens (ROADMAP C28:
the train CLI dropped them) and its batch; the serve CLI.

Tolerances: logits 1e-4 in float32 and 5e-2 in bf16, the paged path 2e-4
(the reference's own bound), the loss 1e-5 relative and gradients 1e-4
of each leaf's max-abs.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.models import paged as jpaged
from repro.models import transformer as jtf
from repro.train.step import loss_fn as j_loss_fn
from repro_torch.collectives import CollectiveEngine, run_local_grid
from repro_torch.convert import tensor_from_numpy
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import (decode_step, decode_step_paged,
                                forward_paged, forward_train, init_pages,
                                prefill)
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousBatchingServer
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_leaves
from torch_util import CPU, configs, port_params

ARCH = "llava-next-34b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PAGED_TOL = 2e-4


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def _model(dtype="float32", seed=0):
    jcfg, tcfg = configs(ARCH, dtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, port_params(jp, tcfg)


def _soft(cfg, b, seed):
    """[b, frontend_tokens, D] soft tokens, 0.02 * normal (the stub
    frontend's scale), float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, cfg.frontend_tokens, cfg.d_model))
            * 0.02).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _batches(soft, toks):
    return ({"soft_emb": jnp.asarray(soft), "tokens": jnp.asarray(toks)},
            {"soft_emb": _t(soft), "tokens": torch.from_numpy(toks)})


# --------------------------- dense entry points ------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_prepends_the_soft_tokens(dtype):
    jcfg, tcfg, jp, tp = _model(dtype)
    jb, tb = _batches(_soft(jcfg, 2, 1), _tokens(jcfg, 2, 6, 2))
    want = jtf._embed(jp, jcfg, jb["tokens"], jb["soft_emb"])
    got = ttf._embed(tp, tcfg, tb["tokens"], tb["soft_emb"])
    assert got.shape == (2, 8 + 6, tcfg.d_model)
    assert got.dtype == tcfg.activation_dtype
    np.testing.assert_array_equal(_f32(got.float()), _f32(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax(dtype):
    """Logits over the 16 token positions only (the soft positions are
    cut before the head)."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jb, tb = _batches(_soft(jcfg, 2, 3), _tokens(jcfg, 2, 16, 4))
    want, _ = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch=jb)
    with torch.no_grad():
        got, aux = forward_train(tp, tcfg, tb)
    assert got.shape == (2, 16, tcfg.vocab_size) and aux == 0.0
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_forward_train_long_sequence_takes_chunked_attention():
    """8 soft + 4088 tokens = 4096 positions > 2048: the chunked branch
    (n_soft + S a multiple of its 1024-key chunk, as the reference
    asserts), in both packages."""
    jcfg, tcfg, jp, tp = _model("float32")
    jb, tb = _batches(_soft(jcfg, 1, 5), _tokens(jcfg, 1, 4088, 6))
    want, _ = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch=jb)
    with torch.no_grad():
        got, _ = forward_train(tp, tcfg, tb)
    assert got.shape == (1, 4088, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_padded_decode_match_jax(dtype):
    """The cache covers n_soft + S positions and ``pos`` is n_soft + S;
    three greedy decode steps after padding the cache by 8."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jb, tb = _batches(_soft(jcfg, 2, 7), _tokens(jcfg, 2, 12, 8))
    jlast, jcache = jtf.prefill(jp, jcfg, jb)
    with torch.no_grad():
        tlast, tcache = prefill(tp, tcfg, tb)
    tol = TOL[dtype]
    np.testing.assert_allclose(tlast.numpy(), _f32(jlast), rtol=tol,
                               atol=tol)
    assert tcache["k"].shape[2] == 8 + 12
    assert int(tcache["pos"]) == int(jcache["pos"]) == 20
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
        np.testing.assert_allclose(tlast.numpy(), _f32(jlast), rtol=tol,
                                   atol=tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(_f32(tcache[key].float()),
                                   _f32(jcache[key]), rtol=tol, atol=tol)
    assert int(tcache["pos"]) == 23


# ------------------------------ the paged path ------------------------- #
def _paged_run(pkg, params, cfg, soft, toks, nxt, chunk, use_kernel=False):
    """Chunked paged prefill (the soft tokens on the first chunk, ``ctx``
    advanced by them) then one decode step; returns each chunk's valid
    logits, the decode logits and the pool."""
    t = _t if pkg == "t" else jnp.asarray
    fwd = forward_paged if pkg == "t" else jpaged.forward_paged
    dec = decode_step_paged if pkg == "t" else jpaged.decode_step_paged
    pages = (init_pages(cfg, 10, 8, CPU) if pkg == "t"
             else jpaged.init_pages(cfg, 10, 8))
    bt = np.asarray([[1, 2, 3, 4, 5, 6]], np.int32)
    s, n_soft = toks.shape[1], soft.shape[1]
    ctx, off, outs = 0, 0, []
    while off < s:
        n = min(chunk, s - off)
        tb = np.zeros((1, chunk), np.int32)
        tb[:, :n] = toks[:, off:off + n]
        batch = {"tokens": t(tb)}
        if off == 0:
            batch["soft_emb"] = t(soft)
        lg, pages = fwd(params, cfg, pages, batch, t(bt),
                        t(np.asarray([ctx], np.int32)),
                        t(np.asarray([n], np.int32)))
        assert lg.shape[1] == chunk
        outs.append(_f32(lg)[:, :n] if pkg == "j" else lg[:, :n].numpy())
        ctx += n + (n_soft if off == 0 else 0)
        off += n
    kw = {"use_kernel": use_kernel}
    lg, pages = dec(params, cfg, pages, {"tokens": t(nxt)}, t(bt),
                    t(np.asarray([ctx], np.int32)), **kw)
    outs.append(_f32(lg) if pkg == "j" else lg.numpy())
    return outs, _f32(pages["k"]) if pkg == "j" else pages["k"].numpy()


@pytest.mark.parametrize("chunk", [8, 12])
def test_forward_paged_with_soft_tokens_matches_jax(chunk):
    """Every chunk's valid logits, the decode logits (the gathered path
    and the kernel entry point, its plain version on the CPU) and the
    written pool, against the reference's."""
    jcfg, tcfg, jp, tp = _model("float32")
    soft, toks = _soft(jcfg, 1, 9), _tokens(jcfg, 1, 12, 10)
    nxt = _tokens(jcfg, 1, 1, 11)
    want, jk = _paged_run("j", jp, jcfg, soft, toks, nxt, chunk)
    for use_kernel in (False, True):
        got, tk = _paged_run("t", tp, tcfg, soft, toks, nxt, chunk,
                             use_kernel)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=PAGED_TOL)
        np.testing.assert_allclose(tk, jk, rtol=0, atol=PAGED_TOL)


@pytest.mark.parametrize("chunk", [8, 12])
def test_forward_paged_matches_the_dense_cache(chunk):
    """The reference's ``test_paged_matches_dense_cache`` for the port:
    the paged prefill's last logits equal the dense prefill's, and the
    paged decode (gathered and kernel entry point) the padded dense
    decode's and the full forward's at the next position."""
    _, tcfg, _, tp = _model("float32")
    soft, toks = _soft(tcfg, 1, 12), _tokens(tcfg, 1, 12, 13)
    tb = {"soft_emb": _t(soft), "tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        lg_dense, cache = prefill(tp, tcfg, tb)
        nxt = lg_dense[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        cache = dict(cache, **{k: torch.nn.functional.pad(
            cache[k], (0, 0, 0, 0, 0, 8)) for k in ("k", "v")})
        lg_dense2, _ = decode_step(tp, tcfg, cache, {"tokens": nxt})
        lg_full, _ = forward_train(
            tp, tcfg, dict(tb, tokens=torch.cat([tb["tokens"], nxt], 1)))
        for use_kernel in (False, True):
            outs, _ = _paged_run("t", tp, tcfg, soft, toks, nxt.numpy(),
                                 chunk, use_kernel)
            errs = {"prefill": np.abs(outs[-2][:, -1]
                                      - lg_dense[:, -1].numpy()).max(),
                    "decode_vs_dense": np.abs(
                        outs[-1][:, 0] - lg_dense2[:, 0].numpy()).max(),
                    "decode_vs_full": np.abs(
                        outs[-1][:, 0] - lg_full[:, -1].numpy()).max()}
            assert max(errs.values()) < PAGED_TOL, (use_kernel, errs)


# ------------------------------ the server ----------------------------- #
SERVE = dict(batch_size=4, max_len=40, block_size=4, prefill_chunk=8,
             num_blocks=1 + 20)


def _requests(pkg, cfg, as_array):
    """7 vision requests: prompts of 3-14 tokens, 8 soft tokens each
    (seeded by the request id), 5-10 greedy tokens; the pool is small
    enough to preempt."""
    rng = np.random.default_rng(21)
    out = []
    for rid in range(7):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(3, 15))).astype(np.int32)
        out.append(pkg.Request(rid=rid, prompt=prompt,
                               max_new_tokens=int(rng.integers(5, 11)),
                               soft_emb=as_array(_soft(cfg, 1, 100 + rid))))
    return out


def _serve_torch(tcfg, tp, grid=None):
    engine = (CollectiveEngine(persist=False, device="cpu")
              if grid is not None else None)
    srv = ContinuousBatchingServer(tcfg, tp, grid=grid, engine=engine,
                                   device="cpu", **SERVE)
    for req in _requests(tserving, tcfg, lambda a: a):
        srv.submit(req)
    return srv.run(), srv.snapshot()


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg, jp, tp = _model("float32")
    jsrv = jserving.ContinuousBatchingServer(jcfg, jp, **SERVE)
    for req in _requests(jserving, jcfg, jnp.asarray):
        jsrv.submit(req)
    want = jsrv.run()
    return tcfg, tp, want, jsrv.snapshot()


def test_vision_streams_match_jax_server(served):
    """Greedy streams equal the reference server's; neither caches a
    vision prefix (their content is not the tokens); both preempt and
    replay with the soft tokens on the replay's first chunk."""
    tcfg, tp, want, jsnap = served
    got, snap = _serve_torch(tcfg, tp)
    assert got == want
    assert all(len(got[rid]) >= 5 for rid in range(7))
    assert snap.cached_prefix_tokens == jsnap.cached_prefix_tokens == 0
    assert snap.preemptions > 0
    assert (snap.preemptions, snap.decode_steps, snap.prefill_chunks) == \
        (jsnap.preemptions, jsnap.decode_steps, jsnap.prefill_chunks)


def test_vision_streams_on_a_dp_grid_equal_one_server(served):
    """Vision requests on a 2-rank ("data",) thread grid: every rank's
    streams equal one server's (the code path of ``grid=`` is the
    same)."""
    tcfg, tp, want, _ = served
    outs = run_local_grid(lambda g: _serve_torch(tcfg, tp, g), (2,),
                          ("data",), device="cpu")
    for got, snap in outs:
        assert got == want
        assert snap.cached_prefix_tokens == 0


def test_serve_cli_serves_vision_and_refuses_encdec(capsys):
    """The serve CLI draws each request's soft tokens and adds them to
    ``max_len``; it refuses the encoder-decoder with the reference's
    reason (not a paged family)."""
    from repro_torch.launch import serve
    results = serve.main(["--arch", ARCH, "--device", "cpu", "--requests",
                          "3", "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "3"])
    assert sorted(results) == [0, 1, 2]
    assert all(len(v) == 3 for v in results.values())
    out = capsys.readouterr().out
    assert f"{ARCH} on cpu: 3 requests, 9 tokens" in out
    assert "cached 0 (0%)" in out
    with pytest.raises(SystemExit, match="family 'encdec'.* not servable: "
                       "the paged KV cache covers the dense and MoE decoder "
                       "families"):
        serve.main(["--arch", "whisper-medium", "--device", "cpu"])


# ------------------------------ the trainer ---------------------------- #
def test_train_step_with_soft_tokens_matches_jax_loss_fn():
    """ROADMAP C28: the port's train step on a reduced llava batch with
    ``soft_emb`` gives the reference's ``loss_fn`` value and gradients,
    from the same weights and inputs (float32); the train CLI's batch
    carries ``soft_emb`` [B, frontend_tokens, d_model]."""
    from repro_torch.launch import train
    jcfg, tcfg, jp, tp = _model("float32")
    data = SyntheticLMDataset(DataConfig(jcfg.vocab_size, 16, 2))
    b = train.build_batch(tcfg, data.batch(0),
                          train.step_generator(0, 0, "cpu"), "cpu")
    assert set(b) == {"tokens", "labels", "soft_emb"}
    assert b["soft_emb"].shape == (2, tcfg.frontend_tokens, tcfg.d_model)
    assert b["soft_emb"].dtype == tcfg.activation_dtype
    jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        functools.partial(j_loss_fn, cfg=jcfg, batch=jb), has_aux=True)(jp)
    loss, _, grads = value_and_grad(tp, tcfg, b)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want = port_params(jgrads, tcfg)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert err < 1e-4, err
    # the soft tokens move the loss: the step without them is another one
    loss_text, _, _ = value_and_grad(tp, tcfg, {k: v for k, v in b.items()
                                                if k != "soft_emb"})
    assert abs(float(loss_text) - float(loss)) > 1e-4


def test_train_cli_feeds_soft_tokens(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", ARCH, "--reduced", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert f"[train] done: 3 steps of {ARCH} on cpu" in \
        capsys.readouterr().out
