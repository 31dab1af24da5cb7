"""The port's dense decoder against the JAX package's, from the same
weights (``convert.params_from_jax``) and tokens: ``forward_train``
logits of reduced ``minicpm-2b`` (MHA) and ``mistral-nemo-12b`` (GQA) in
float32 and bfloat16, one S 4096 case on the chunked-attention branch;
three WSD train steps; ``prefill`` + ``decode_step`` with and without
cache headroom (the reference's write position, reproduced); then the
train CLI on the CPU and the CPU kernel route.

Tolerances: logits 1e-4 in float32 and 5e-2 in bfloat16 (the same
arithmetic in other summation orders; bf16 rounds at the same points);
train steps 1e-5 relative on loss and gradient norm and 1e-5 absolute on
the parameters, as for the SSM trainer (``test_torch_train.py``).
"""

import functools

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
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import (decode_step, forward_train, init_cache,
                                init_params, prefill)
from repro_torch.optim import adamw
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_prefill_step, make_train_step
from repro_torch.tree import tree_leaves, tree_map
from torch_util import configs, jax_params_numpy, port_params

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _model(arch, dtype, seed=0):
    jcfg, tcfg = configs(arch, dtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, port_params(jp, tcfg)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mistral-nemo-12b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_logits_match_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _model(arch, dtype)
    toks = _tokens(jcfg, 2, 24, seed=1)
    want, jaux = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch={"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got, aux = forward_train(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and aux == float(jaux) == 0.0
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_forward_train_long_sequence_takes_chunked_attention():
    """S 4096 > 2048: the reference's chunked attention in every layer;
    on the CPU the port's default and its kernel route both take the
    plain chunked path, match, and launch no kernel."""
    jcfg, tcfg, jp, tp = _model("minicpm-2b", "float32")
    toks = _tokens(jcfg, 1, 4096, seed=2)
    want, _ = jax.jit(functools.partial(jtf.forward_train, cfg=jcfg))(
        jp, batch={"tokens": jnp.asarray(toks)})
    ops.reset_launch_counts()
    with torch.no_grad():
        for use_kernel in (None, True):
            got, _ = forward_train(tp, tcfg,
                                   {"tokens": torch.from_numpy(toks)},
                                   use_kernel=use_kernel)
            np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-4,
                                       atol=1e-4)
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def test_train_steps_match_jax():
    """Three train steps of reduced float32 minicpm-2b (remat on, the
    WSD schedule launch/train.py picks for it): loss, gradient norm and
    every parameter after each step."""
    jcfg, tcfg, jp, tp = _model("minicpm-2b", "float32")
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3, schedule="wsd")
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
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        want = port_params(jstate.params, tcfg)
        for got_t, want_t in zip(tree_leaves(tstate.params),
                                 tree_leaves(want)):
            np.testing.assert_allclose(got_t.numpy(), want_t.numpy(),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mistral-nemo-12b"])
@pytest.mark.parametrize("headroom", [8, 0])
def test_prefill_and_decode_match_jax(arch, headroom):
    """Prefill, then three greedy decode steps from each package's own
    cache.  With 8 positions of headroom (the reference's own test pads
    so) decode appends; with none, the reference writes each new K/V at
    ``min(pos, Smax - 1)``, over the last cached position, and the port
    does the same."""
    jcfg, tcfg, jp, tp = _model(arch, "float32")
    toks = _tokens(jcfg, 2, 12, seed=3)
    jlast, jcache = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tlast, tcache = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tlast.numpy(), _f32(jlast), rtol=1e-4,
                               atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), _f32(jcache[key]),
                                   rtol=1e-5, atol=1e-5)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 12
    if headroom:
        pad = [(0, 0), (0, 0), (0, headroom), (0, 0), (0, 0)]
        jcache = dict(jcache, k=jnp.pad(jcache["k"], pad),
                      v=jnp.pad(jcache["v"], pad))
        tpad = (0, 0, 0, 0, 0, headroom)
        tcache = dict(tcache, k=torch.nn.functional.pad(tcache["k"], tpad),
                      v=torch.nn.functional.pad(tcache["v"], tpad))
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
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), _f32(jcache[key]),
                                   rtol=1e-5, atol=1e-5)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 15


def test_decode_with_headroom_follows_the_teacher_forced_forward():
    """With headroom, each decode step's logits equal the full forward's
    at its position (the check chip_smoke.py makes on the card)."""
    _, tcfg, _, tp = _model("mistral-nemo-12b", "float32")
    seq = torch.from_numpy(_tokens(tcfg, 2, 14, seed=4))
    with torch.no_grad():
        full, _ = forward_train(tp, tcfg, {"tokens": seq})
        last, cache = make_prefill_step(tcfg)(tp, {"tokens": seq[:, :8]})
        cache = dict(cache, **{k: torch.nn.functional.pad(
            cache[k], (0, 0, 0, 0, 0, 8)) for k in ("k", "v")})
        steps = [last]
        for t in range(8, 14):
            last, cache = decode_step(tp, tcfg, cache,
                                      {"tokens": seq[:, t:t + 1]})
            steps.append(last)
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 7:], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["minicpm-2b", "falcon-mamba-7b"])
def test_init_cache_matches_jax_layout(arch):
    jcfg, tcfg = configs(arch, "bfloat16")
    want = jtf.init_cache(jcfg, 3, 20)
    got = init_cache(tcfg, 3, 20, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
        assert not got[key].any(), key


def test_init_params_layout_matches_jax():
    """The port's own random weights have the reference's shapes and
    dtypes, layer by layer (GQA projections, bf16)."""
    jcfg, tcfg = configs("mistral-nemo-12b", "bfloat16")
    jp = jax_params_numpy(jtf.init_params(jax.random.PRNGKey(0), jcfg))
    params = init_params(tcfg, seed=1, device="cpu")
    assert len(params["layers"]) == tcfg.num_layers
    for lp in params["layers"]:
        assert set(lp) == set(jp["layers"])
        for name, arr in jp["layers"].items():
            assert tuple(lp[name].shape) == arr.shape[1:], name
            assert lp[name].dtype == torch.bfloat16, name


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_moe_family_runs_every_entry_point(arch):
    """The MoE family, refused before its slice (ROADMAP A.4), runs
    through init_params, init_cache, forward_train, prefill and
    decode_step (its parity with the reference: test_torch_moe.py)."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 8, seed=5))
    with torch.no_grad():
        logits, aux = forward_train(params, cfg, {"tokens": toks})
        last, cache = prefill(params, cfg, {"tokens": toks})
        cache = dict(cache, **{k: torch.nn.functional.pad(
            cache[k], (0, 0, 0, 0, 0, 4)) for k in ("k", "v")})
        step, cache = decode_step(params, cfg, cache,
                                  {"tokens": toks[:, :1]})
    assert logits.shape == (2, 8, cfg.vocab_size) and float(aux) > 0
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    assert set(init_cache(cfg, 2, 8, device="cpu")) == {"k", "v", "pos"}
    assert int(cache["pos"]) == 9


def test_train_cli_dense_on_cpu(capsys):
    from repro_torch.launch import train
    losses = train.main(["--arch", "minicpm-2b", "--reduced", "--steps",
                         "5", "--batch", "4", "--seq", "64", "--device",
                         "cpu"])
    assert len(losses) == 5 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "[train] done: 5 steps of minicpm-2b on cpu" in out


def test_cpu_kernel_route_launches_nothing():
    """make_train_step with use_kernel=True on CPU parameters takes the
    one plain attention path of the CPU: no launch, and the same step as
    the plain route."""
    _, tcfg, _, tp = _model("minicpm-2b", "float32")
    data = JDataset(JDataConfig(tcfg.vocab_size, 4096, 1))
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    out = {}
    for use_kernel in (True, False):
        state = init_train_state(tree_map(torch.clone, tp))
        step = make_train_step(tcfg, adamw.AdamWConfig(lr=1e-3,
                                                       warmup_steps=1,
                                                       total_steps=2),
                               use_kernel=use_kernel)
        ops.reset_launch_counts()
        state, metrics = step(state, batch)
        assert not any(ops.launch_counts().values())
        out[use_kernel] = (float(metrics["loss"]),
                           float(metrics["grad_norm"]))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-5)
    assert out[True][1] == pytest.approx(out[False][1], rel=1e-4)
