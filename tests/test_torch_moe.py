"""The port's MoE FFN and MoE decoder family against the JAX package's,
from the same numpy inputs and weights (``convert.params_from_jax``).

* ``moe_ffn`` against ``repro.models.moe.moe_ffn``: float32 at 1e-5 with
  the routing itself equal (``top_e``, each entry's position within its
  expert and the capacity mask, recomputed with the reference's jnp
  lines), bfloat16 within the reference tests' 5e-2, the aux loss at
  1e-6, and the gradients of the router, the three expert weights and x
  against ``jax.grad`` at 1e-4; each with a capacity factor that drops
  tokens and one that drops none.
* The combine is deterministic (no atomics): two calls are bitwise equal,
  and it adds a token's k results in ascending expert id, the order of
  the reference's sequential scatter-add.
* Reduced ``olmoe-1b-7b`` and ``arctic-480b`` (the dense residual):
  ``forward_train`` logits and aux (float32 1e-4; bfloat16 each package
  against the float32 forward, the port within one ulp of the
  reference's own error; the aux 1e-4 / 5e-2 relative), three AdamW
  train steps (loss and gradient norm 1e-5 relative, parameters 1e-5
  absolute), ``prefill`` +
  ``decode_step`` logits at equal grouping, and the parameter layout.
* Serving: greedy streams of reduced ``olmoe-1b-7b`` through
  ``ContinuousBatchingServer`` equal the reference server's token for
  token, with and without the prefix cache.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train.state import init_train_state as j_init_state
from repro.train.step import make_train_step as j_make_step
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, prefill)
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.serving import ContinuousBatchingServer
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves
from torch_util import configs, jax_params_numpy, port_params

G, GS, D, E, F, K = 3, 16, 12, 8, 24, 2
#: capacity factors: 1.25 drops a few entries of these groups, 4.0 none
CAPACITY = {"drops": 1.25, "no_drops": 4.0}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, GS, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) * 0.5).astype(np.float32)
    wg = (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32)
    wu = (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32)
    wd = (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32)
    return x, router, wg, wu, wd


def _jax_routing(x, router, top_k, capacity_factor):
    """The reference's routing lines (``repro/models/moe.py:43-66``)."""
    g, gs, _ = x.shape
    e = router.shape[1]
    cap = jmoe.moe_capacity(gs, e, top_k, capacity_factor)
    probs = jax.nn.softmax(x @ router, axis=-1)
    _, top_e = jax.lax.top_k(probs, top_k)
    flat_e = top_e.reshape(g, gs * top_k)
    sort_idx = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, sort_idx, axis=1)
    counts = jnp.sum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=1)
    starts = jnp.cumsum(counts, axis=1) - counts
    pos = jnp.arange(gs * top_k)[None, :] - jnp.take_along_axis(
        starts, sorted_e, axis=1)
    return np.asarray(top_e), np.asarray(pos), np.asarray(pos < cap)


@pytest.mark.parametrize("case", list(CAPACITY))
def test_moe_ffn_float32_matches_jax_with_its_routing(case):
    cf = CAPACITY[case]
    args = _inputs()
    want, jaux = jmoe.moe_ffn(*map(jnp.asarray, args), top_k=K,
                              capacity_factor=cf)
    got, aux = moe.moe_ffn(*map(torch.from_numpy, args), top_k=K,
                           capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)
    top_e, pos, keep = _jax_routing(*map(jnp.asarray, args[:2]), K, cf)
    r = moe.Routing(torch.from_numpy(args[0]), torch.from_numpy(args[1]), K,
                    cf)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (case == "drops"), dropped


@pytest.mark.parametrize("case", list(CAPACITY))
def test_moe_ffn_bfloat16_matches_jax(case):
    args = _inputs(seed=1)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    jargs[1] = jnp.asarray(args[1])            # the router stays float32
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    targs[1] = torch.from_numpy(args[1])
    want, jaux = jmoe.moe_ffn(*jargs, top_k=K,
                              capacity_factor=CAPACITY[case])
    got, aux = moe.moe_ffn(*targs, top_k=K, capacity_factor=CAPACITY[case])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


@pytest.mark.parametrize("case", list(CAPACITY))
def test_moe_ffn_gradients_match_jax_grad(case):
    cf = CAPACITY[case]
    args = _inputs(seed=2)
    ct = np.random.default_rng(3).normal(size=(G, GS, D)).astype(np.float32)

    def jloss(x, router, wg, wu, wd):
        out, aux = jmoe.moe_ffn(x, router, wg, wu, wd, top_k=K,
                                capacity_factor=cf)
        return jnp.sum(out * jnp.asarray(ct)) + 0.5 * aux

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux = moe.moe_ffn(*leaves, top_k=K, capacity_factor=cf)
    (torch.sum(out * torch.from_numpy(ct)) + 0.5 * aux).backward()
    for name, leaf, w in zip(("x", "router", "wg", "wu", "wd"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_moe_combine_is_deterministic_in_expert_order():
    """Two calls are bitwise equal, and each token's output is its k
    weighted expert results added in ascending expert id."""
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(seed=4)]
    args[1] = args[1].float()
    a, _ = moe.moe_ffn(*args, top_k=K)
    b, _ = moe.moe_ffn(*args, top_k=K)
    assert torch.equal(a, b)
    r = moe.Routing(args[0], args[1], K, 1.25)
    buf = moe._dispatch(args[0], r, r.sorted_e, r.pos, r.keep, E)
    y = moe._experts(buf, *args[2:])
    want = torch.zeros_like(args[0])
    for g in range(G):
        for j in range(GS * K):                 # sorted order, as XLA's
            if r.keep[g, j]:
                t = int(r.token_of[g, j])
                want[g, t] = want[g, t] + (y[g, r.sorted_e[g, j],
                                             r.pos[g, j]]
                                           * r.w_sorted[g, j])
    assert torch.equal(a, want)


def test_moe_capacity_matches_jax():
    for gs, e, k, cf in ((32, 64, 8, 1.25), (1, 64, 8, 1.25),
                         (4096, 64, 8, 1.25), (16, 4, 2, 1.25),
                         (8, 128, 2, 0.5)):
        assert moe.moe_capacity(gs, e, k, cf) == jmoe.moe_capacity(
            gs, e, k, cf)
    # the issue's numbers for olmoe-1b-7b: a prefill chunk, a decode step
    # and a train row
    assert [moe.moe_capacity(s, 64, 8, 1.25) for s in (32, 1, 4096)] == \
        [8, 8, 640]


# ---------------------------------------------------------------------- #
# the MoE decoder family
# ---------------------------------------------------------------------- #
def _model(arch, dtype, seed=0):
    jcfg, tcfg = configs(arch, dtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, port_params(jp, tcfg)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_and_aux_match_jax(arch, dtype):
    """float32: the logits at 1e-4.  bfloat16: both packages round at
    their own points (Arctic's dense residual adds a third product to
    every layer, and the two drift apart by up to ~5.5 ulps of the
    logits, 0.086 on this input), so each is held to the float32
    forward of the same weights: the port's largest error may exceed
    the reference's own by one bf16 ulp of the largest logit."""
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    toks = _tokens(jcfg, 2, 24, seed=1)
    want, jaux = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch={"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = forward_train(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        jcfg32 = dataclasses.replace(jcfg, dtype="float32")
        up = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        exact, _ = jtf.forward_train(up, jcfg32,
                                     {"tokens": jnp.asarray(toks)})
        exact = np.asarray(exact)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(exact).max())) - 7)
        err, ref_err = (float(np.abs(a - exact).max()) for a in (got, want))
        assert err <= ref_err + ulp, (err, ref_err, ulp)
    assert float(aux) == pytest.approx(float(jaux), rel=TOL[dtype])
    assert float(aux) > 0


def test_train_steps_match_jax():
    """Three AdamW steps of reduced float32 olmoe-1b-7b (remat on; the
    loss is ce + 0.01 aux): loss, gradient norm and every parameter."""
    jcfg, tcfg, jp, tp = _model("olmoe-1b-7b", "float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, schedule="cosine")
    jstep = jax.jit(j_make_step(jcfg, jadamw.AdamWConfig(**kw)))
    tstep = make_train_step(tcfg, adamw.AdamWConfig(**kw))
    jstate, tstate = j_init_state(jp), init_train_state(tp)
    data = JDataset(JDataConfig(jcfg.vocab_size, 32, 4))
    for step in range(3):
        b = data.batch(step)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["aux"]) == pytest.approx(float(jm["aux"]),
                                                 rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        want = port_params(jstate.params, tcfg)
        for got_t, want_t in zip(tree_leaves(tstate.params),
                                 tree_leaves(want)):
            np.testing.assert_allclose(got_t.numpy(), want_t.numpy(),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_prefill_and_decode_match_jax(arch):
    """Prefill [2, 12] (the MoE groups are the rows, as in the reference)
    with 8 positions of headroom, then three greedy decode steps [2, 1]
    from each package's own cache."""
    jcfg, tcfg, jp, tp = _model(arch, "float32")
    toks = _tokens(jcfg, 2, 12, seed=3)
    jlast, jcache = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlast, tcache = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
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
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_init_params_and_cache_layout_match_jax(arch):
    """The port's own random weights have the reference's shapes and
    dtypes (the router float32 in a bf16 model; Arctic's dense_mlp)."""
    jcfg, tcfg = configs(arch, "bfloat16")
    jp = jax_params_numpy(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    params = init_params(tcfg, seed=1, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp["layers"])[0]
    assert len(params["layers"]) == tcfg.num_layers
    for lp in params["layers"]:
        for path, arr in flat:
            leaf = lp
            for key in path:
                leaf = leaf[key.key]
            assert tuple(leaf.shape) == arr.shape[1:], path
            assert str(leaf.dtype).split(".")[-1] == str(arr.dtype), path
    assert ("dense_mlp" in params["layers"][0]) == (arch == "arctic-480b")
    want = jtf.init_cache(jcfg, 3, 20)
    got = init_cache(tcfg, 3, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #
SERVE = dict(batch_size=3, max_len=32, block_size=4, prefill_chunk=8,
             num_blocks=1 + 14)


def _requests(pkg, vocab):
    """8 requests over 2 shared system prompts (prefix hits, one exact
    repeat) and enough decode to exhaust the pool (preemption)."""
    rng = np.random.default_rng(42)
    shared = [rng.integers(0, vocab, 8) for _ in range(2)]
    out = []
    for rid in range(8):
        sfx = rng.integers(0, vocab, int(rng.integers(0, 6)))
        if rid == 5:
            sfx = sfx[:0]
        prompt = np.concatenate([shared[rid % 2], sfx]).astype(np.int32)
        out.append(pkg.Request(rid=rid, prompt=prompt,
                               max_new_tokens=int(rng.integers(6, 13))))
    return out


@pytest.fixture(scope="module")
def olmoe():
    return _model("olmoe-1b-7b", "float32")


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix_cache", "no_prefix_cache"])
def test_olmoe_greedy_streams_match_jax_server(olmoe, prefix_cache):
    jcfg, tcfg, jp, tp = olmoe
    jsrv = jserving.ContinuousBatchingServer(jcfg, jp,
                                             prefix_cache=prefix_cache,
                                             **SERVE)
    for req in _requests(jserving, jcfg.vocab_size):
        jsrv.submit(req)
    want = jsrv.run()
    srv = ContinuousBatchingServer(tcfg, tp, device="cpu",
                                   prefix_cache=prefix_cache, **SERVE)
    for req in _requests(tserving, tcfg.vocab_size):
        srv.submit(req)
    got = srv.run()
    assert got == want
    snap, jsnap = srv.snapshot(), jsrv.snapshot()
    assert snap.preemptions > 0
    assert (snap.cached_prefix_tokens > 0) == prefix_cache
    assert (snap.cached_prefix_tokens, snap.preemptions,
            snap.decode_steps, snap.prefill_chunks) == \
        (jsnap.cached_prefix_tokens, jsnap.preemptions,
         jsnap.decode_steps, jsnap.prefill_chunks)
