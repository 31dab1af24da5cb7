"""The port's RG-LRU hybrid (recurrentgemma-9b's family) against the JAX
package's, on the same weights (moved across as numpy) and inputs.

The model runs the reduced config with 5 layers: one (rglru, rglru,
local) cycle and a 2-block RG-LRU tail, so that both halves of the
reference's layout run, with window 32.

Tolerances: the RG-LRU block 1e-5 in float32 (the same float32
recurrence; the doubling prefix adds in another order than
``lax.associative_scan``) and 5e-2 in bf16 (both round the projections
to bf16 at the same places, with sums in other orders); its weight
gradients 1e-4 of each gradient's max-abs; model logits 1e-4 in float32
and 5e-2 in bf16; one AdamW step 1e-5 relative on the loss and gradient
norm and 1e-5 absolute on the parameters, as ``test_torch_train.py``;
the plain flash at head dim 256 2e-5 against the Pallas kernel in
interpret mode, and its backward 1e-4 of each gradient's max-abs against
``jax.grad`` of the reference's chunked attention, as
``test_torch_head_dims.py``.

The decode cache is where the port parts from the reference on purpose
(ROADMAP C25): the reference's prefill stores the trailing window from
slot 0 while its decode writes position ``pos`` at slot ``pos % w``, so
its decode attends over the wrong keys after a prompt whose length is
not a multiple of the window.  At lengths 32 and 64 the two caches and
decodes agree; at 19, 39 and 63 the port's decode follows its own
``forward_train`` and a witness shows the reference's gap.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jl
from repro.models import rglru as jrg
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.state import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.convert import tensor_from_numpy
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, prefill)
from repro_torch.models import rglru
from repro_torch.optim import adamw
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import stacked_ndims, tree_leaves, tree_unflatten
from torch_util import configs, jax_params_numpy, port_params

CPU = torch.device("cpu")
D, HEADS, K_CONV = 32, 4, 4
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _f32(a):
    return np.asarray(a, np.float32)


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def _block(dtype, seed=0):
    jdt = jnp.dtype(dtype)
    p = jrg.init_rglru_params(jax.random.PRNGKey(seed), D, D, HEADS, K_CONV,
                              jdt)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    conv = rng.normal(size=(2, K_CONV - 1, D)).astype(np.float32)
    h = rng.normal(size=(2, D)).astype(np.float32)
    return p, {k: _t(v) for k, v in p.items()}, x, conv, h, jdt


def _hybrid(dtype="float32"):
    jcfg, tcfg = configs("recurrentgemma-9b", dtype)
    jcfg = dataclasses.replace(jcfg, num_layers=5)
    tcfg = dataclasses.replace(tcfg, num_layers=5)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, port_params(jp, tcfg)


def _tokens(n, seed=4, b=2):
    return np.random.default_rng(seed).integers(
        0, 256, size=(b, n)).astype(np.int32)


# ----------------------------- the block ------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_matches_jax(dtype):
    """The block from zeros, from a carried state (conv shift register and
    h) and one single step from that state."""
    p, tp, x, conv, h, jdt = _block(dtype)
    tol = TOL[dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = _t(jx)
    jstate = jrg.RGLRUState(conv=jnp.asarray(conv).astype(jdt),
                            h=jnp.asarray(h))
    tstate = rglru.RGLRUState(conv=_t(jstate.conv), h=torch.from_numpy(h))
    cases = [(jx, None, tx, None, False),
             (jx, jstate, tx, tstate, False),
             (jx[:, :1], jstate, tx[:, :1], tstate, True)]
    for jin, jst, tin, tst, single in cases:
        jy, jnew = jrg.rglru_block(jin, p, state=jst, single_step=single)
        ty, tnew = rglru.rglru_block(tin, tp, state=tst, single_step=single)
        assert ty.dtype == tx.dtype and tnew.h.dtype == torch.float32
        np.testing.assert_allclose(_f32(ty.float()), _f32(jy), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(tnew.h.numpy(), _f32(jnew.h), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(_f32(tnew.conv.float()),
                                   _f32(jnew.conv), rtol=tol, atol=tol)


def test_rglru_weight_gradients_match_jax():
    p, tp, x, _, _, _ = _block("float32", seed=3)
    jg = jax.grad(lambda q: jrg.rglru_block(jnp.asarray(x), q)[0].sum())(p)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, _ = rglru.rglru_block(torch.from_numpy(x), leaves)
    grads = torch.autograd.grad(y.sum(), list(leaves.values()))
    for name, g in zip(leaves, grads):
        r = np.asarray(jg[name])
        err = np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-9)
        assert err < 1e-4, (name, err)


def test_init_rglru_params_layout():
    gen = torch.Generator().manual_seed(0)
    p = rglru.init_rglru_params(gen, D, D, HEADS, K_CONV, torch.bfloat16)
    ref = jrg.init_rglru_params(jax.random.PRNGKey(0), D, D, HEADS, K_CONV,
                                jnp.bfloat16)
    assert set(p) == set(ref)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == str(v.dtype), k
    np.testing.assert_allclose(p["lam"].numpy(), np.asarray(ref["lam"]),
                               rtol=1e-6)


# ----------------------------- the model ------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_layout_matches_reference(dtype):
    """The port's own random weights have the reference's tree: cycles
    unstacked into per-cycle lists, the tail a tuple; every shape and
    dtype (``lam`` float32 in a bf16 model); the stacked ranks the
    optimizer's weight decay reads are the reference's."""
    jcfg, tcfg = configs("recurrentgemma-9b", dtype)
    jcfg = dataclasses.replace(jcfg, num_layers=5)
    tcfg = dataclasses.replace(tcfg, num_layers=5)
    jp = jax_params_numpy(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tp = init_params(tcfg, seed=1, device="cpu")
    assert set(tp) == set(jp) == {"embed", "ln_f", "head", "cycles", "tail"}
    assert isinstance(tp["tail"], tuple) and len(tp["tail"]) == 2
    for name, stacked in jp["cycles"].items():
        assert len(tp["cycles"][name]) == 1
        for leaf, arr in stacked.items():
            got = tp["cycles"][name][0][leaf]
            assert tuple(got.shape) == arr.shape[1:], (name, leaf)
            assert str(got.dtype).split(".")[-1] == str(arr.dtype)
    for got, want in zip(tp["tail"], jp["tail"]):
        for leaf, arr in want.items():
            assert tuple(got[leaf].shape) == arr.shape, leaf
            assert str(got[leaf].dtype).split(".")[-1] == str(arr.dtype)
    assert tp["tail"][0]["lam"].dtype == torch.float32
    assert stacked_ndims(tp) == [a.ndim for a in jax.tree.leaves(jp)]
    meta = init_params(tcfg, device="meta")
    assert [t.shape for t in tree_leaves(meta)] == \
        [t.shape for t in tree_leaves(tp)]


def test_params_from_jax_round_trips():
    """Every converted leaf equals the reference's, bit for bit, in its
    dtype, and in the reference's leaf order."""
    _, tcfg, jp, tp = _hybrid("bfloat16")
    want = jax.tree.leaves(jax_params_numpy(jp))
    cycles = [np.stack([_f32(tp["cycles"][b][c][leaf].float())
                        for c in range(len(tp["cycles"][b]))])
              for b in sorted(tp["cycles"])
              for leaf in sorted(tp["cycles"][b][0])]
    got = (cycles + [_f32(tp[k].float()) for k in ("embed", "head", "ln_f")]
           + [_f32(blk[leaf].float()) for blk in tp["tail"]
              for leaf in sorted(blk)])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, _f32(w))
    assert tp["cycles"]["b0"][0]["lam"].dtype == torch.float32
    assert tp["cycles"]["b2"][0]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_matches_jax(dtype):
    """S 64 > window 32, both attention routes (on the CPU both plain)."""
    jcfg, tcfg, jp, tp = _hybrid(dtype)
    toks = _tokens(64)
    jl_, jaux = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch={"tokens": jnp.asarray(toks)})
    tol = MODEL_TOL[dtype]
    with torch.no_grad():
        for use_kernel in (False, True):
            tl, aux = forward_train(tp, tcfg,
                                    {"tokens": torch.from_numpy(toks)},
                                    use_kernel=use_kernel)
            assert aux == 0.0 == float(jaux)
            np.testing.assert_allclose(_f32(tl.float()), _f32(jl_),
                                       rtol=tol, atol=tol)


def test_remat_gradients_equal_the_plain_backward():
    """Checkpointing each cycle changes no gradient."""
    _, tcfg, _, tp = _hybrid()
    toks = torch.from_numpy(_tokens(64, seed=9))
    grads = []
    for remat in (True, False):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
        logits, _ = forward_train(tree_unflatten(tp, leaves), tcfg,
                                  {"tokens": toks}, remat=remat)
        grads.append(torch.autograd.grad(logits.square().mean(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [32, 64])
def test_prefill_and_first_decode_match_jax(n):
    """At prompt lengths that are multiples of the window the port's ring
    is the reference's cache, slot for slot."""
    jcfg, tcfg, jp, tp = _hybrid()
    toks = _tokens(n + 1, seed=n)
    jlast, jcache = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :n])})
    with torch.no_grad():
        tlast, tcache = prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :n])})
    np.testing.assert_allclose(tlast.numpy(), _f32(jlast), rtol=1e-4,
                               atol=1e-4)
    assert set(tcache) == set(jcache)
    for key in ("k", "v", "conv", "h"):
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        np.testing.assert_allclose(tcache[key].numpy(), _f32(jcache[key]),
                                   rtol=1e-4, atol=1e-5)
    assert int(tcache["pos"]) == int(jcache["pos"]) == n
    nxt = toks[:, n:n + 1]
    jl2, _ = jtf.decode_step(jp, jcfg, jcache, {"tokens": jnp.asarray(nxt)})
    with torch.no_grad():
        tl2, tcache = decode_step(tp, tcfg, tcache,
                                  {"tokens": torch.from_numpy(nxt)})
    np.testing.assert_allclose(tl2.numpy(), _f32(jl2), rtol=1e-4, atol=1e-4)
    assert int(tcache["pos"]) == n + 1


@pytest.mark.parametrize("n", [19, 39, 63])
def test_decode_follows_forward_train_across_the_window(n):
    """40 decode steps after a prompt of n tokens, crossing the window
    boundary, each step's logits within 1e-5 of the teacher-forced
    ``forward_train``; the witness: the reference's first decode step
    misses its own forward by more than 1e-2 (C25)."""
    jcfg, tcfg, jp, tp = _hybrid()
    toks = _tokens(n + 40, seed=n)
    with torch.no_grad():
        full, _ = forward_train(tp, tcfg, {"tokens": torch.from_numpy(toks)})
        last, cache = prefill(tp, tcfg, {"tokens": torch.from_numpy(
            toks[:, :n])})
        steps = [last]
        for t in range(n, n + 39):
            last, cache = decode_step(tp, tcfg, cache, {
                "tokens": torch.from_numpy(toks[:, t:t + 1])})
            steps.append(last)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, n - 1:n + 39],
                               rtol=1e-5, atol=1e-5)

    jfull, _ = jtf.forward_train(jp, jcfg, {"tokens": jnp.asarray(toks)})
    _, jcache = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :n])})
    jstep, _ = jtf.decode_step(jp, jcfg, jcache,
                               {"tokens": jnp.asarray(toks[:, n:n + 1])})
    gap = np.abs(_f32(jstep)[:, 0] - _f32(jfull)[:, n]).max()
    assert gap > 1e-2, gap


def test_init_cache_matches_reference_shapes():
    jcfg, tcfg = configs("recurrentgemma-9b")
    jcfg = dataclasses.replace(jcfg, num_layers=5)
    tcfg = dataclasses.replace(tcfg, num_layers=5)
    for max_len in (16, 100):
        want = jtf.init_cache(jcfg, 2, max_len)
        got = init_cache(tcfg, 2, max_len, device="cpu")
        assert set(got) == set(want)
        for key, arr in want.items():
            assert tuple(got[key].shape) == arr.shape, (key, max_len)
            assert str(got[key].dtype).split(".")[-1] == str(arr.dtype)


def test_decode_from_init_cache_follows_forward_train():
    """A cache from ``init_cache`` (no prefill): decoding token by token
    from position 0 gives the forward's logits."""
    _, tcfg, _, tp = _hybrid()
    toks = torch.from_numpy(_tokens(40, seed=2))
    with torch.no_grad():
        full, _ = forward_train(tp, tcfg, {"tokens": toks})
        cache = init_cache(tcfg, 2, 64, device="cpu")
        steps = []
        for t in range(40):
            last, cache = decode_step(tp, tcfg, cache,
                                      {"tokens": toks[:, t:t + 1]})
            steps.append(last)
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=1e-5,
                               atol=1e-5)


def test_adamw_step_matches_jax():
    """One float32 AdamW step of the 5-layer model (remat per cycle), as
    the reference's ``make_train_step``: loss, gradient norm and every
    parameter (the cycles' stacked norms and ``lam`` decay, the tail's
    do not, in both)."""
    jcfg, tcfg, jp, tp = _hybrid()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(j_make_step(jcfg, jadamw.AdamWConfig(**kw)))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**kw))
    b = SyntheticLMDataset(DataConfig(jcfg.vocab_size, 64, 2)).batch(0)
    jstate, jm = jstep(j_init_state(jp),
                       {k: jnp.asarray(v) for k, v in b.items()})
    tstate, tm = tstep(init_train_state(tp),
                       {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    want = port_params(jstate.params, tcfg)
    for got_t, want_t in zip(tree_leaves(tstate.params), tree_leaves(want)):
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=0,
                                   atol=1e-5)


def test_cpu_kernel_route_launches_nothing():
    _, tcfg, _, tp = _hybrid()
    ops.reset_launch_counts()
    with torch.no_grad():
        forward_train(tp, tcfg, {"tokens": torch.from_numpy(_tokens(64))},
                      use_kernel=True)
    assert not any(ops.launch_counts().values())


# --------------------- the flash kernel at D 256 ---------------------- #
def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def test_plain_flash_at_head_dim_256_matches_pallas_interpret():
    """The hybrid's local attention shape cut down: MQA 4/1, D 256,
    causal with a window of 128 over S 256."""
    q, k, v = _qkv(1, 4, 1, 256, 256, seed=256)
    got, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=True, window=128)
    want = pallas_flash(q, k, v, causal=True, window=128, block_q=64,
                        block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert lse.shape == (1, 4, 256) and torch.isfinite(lse).all()


def test_plain_flash_backward_at_head_dim_256_matches_jax_grad():
    b, h, hkv, s, d = 1, 4, 1, 256, 256
    q, k, v = _qkv(b, h, hkv, s, d, seed=7)
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)

    def loss(q_, k_, v_):
        o = jl._chunked_attention(q_, jnp.repeat(k_, h, axis=1),
                                  jnp.repeat(v_, h, axis=1), True, 128,
                                  chunk=64)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash_attention_ref(tq, tk, tv, True, 128)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  True, 128)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (name, err)
