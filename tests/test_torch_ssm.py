"""The port's Mamba block and SSM model against the JAX package's, on
the same weights (moved across as numpy) and the same inputs.

Tolerances: the block's output 1e-4 and its input gradient 1e-3, as the
reference holds its own kernel route against its jnp route
(tests/test_kernels.py:175-181); model logits 1e-4 in float32 and 5e-2
in bfloat16 (the two frameworks round bf16 at the same places but take
sums in other orders).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import transformer as jtf
from repro.models.ssm import init_mamba_params, mamba_block as j_block
from repro_torch.kernels import ops
from repro_torch.models import decode_step, forward_train, prefill
from repro_torch.models.ssm import (SSMState, _causal_conv, init_mamba_params
                                    as t_init, mamba_block)
from torch_util import configs, port_params

D_MODEL, DI, N, R = 32, 64, 8, 4


def _block_inputs(seed=0):
    key = jax.random.PRNGKey(seed)
    p = init_mamba_params(key, D_MODEL, DI, N, R, 4, jnp.float32)
    x = np.random.default_rng(seed).normal(
        size=(2, 32, D_MODEL)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    return p, x, tp


@pytest.mark.parametrize("j_kernel", [False, True])
@pytest.mark.parametrize("t_kernel", [False, True])
def test_mamba_block_matches_jax(j_kernel, t_kernel):
    """Every pairing of the two routes in each package: the JAX jnp
    chunked scan or Pallas (interpret), the port's chunked scan or its
    kernel route (the plain recurrence on the CPU)."""
    p, x, tp = _block_inputs()
    block = functools.partial(j_block, ssm_state=N, use_kernel=j_kernel)
    jy, jst = jax.jit(block)(jnp.asarray(x), p)
    tx = torch.from_numpy(x).requires_grad_()
    ty, tst = mamba_block(tx, tp, ssm_state=N, use_kernel=t_kernel)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.h.detach().numpy(), np.asarray(jst.h),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.conv.detach().numpy(),
                               np.asarray(jst.conv), rtol=1e-6, atol=1e-6)
    jg = jax.jit(jax.grad(lambda z: block(z, p)[0].sum()))(jnp.asarray(x))
    (tg,) = torch.autograd.grad(ty.sum(), tx)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-3,
                               atol=1e-5)


def test_mamba_block_weight_gradients_match_jax():
    """Gradients of every block weight, the port's kernel route (on the
    CPU: autograd of the plain recurrence) against jax.grad of the
    reference's jnp route."""
    p, x, tp = _block_inputs(seed=3)
    jg = jax.jit(jax.grad(lambda q: j_block(jnp.asarray(x), q,
                                            ssm_state=N)[0].sum()))(p)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, _ = mamba_block(torch.from_numpy(x), leaves, ssm_state=N,
                       use_kernel=True)
    grads = torch.autograd.grad(y.sum(), list(leaves.values()))
    for (name, _), g in zip(leaves.items(), grads):
        r = np.asarray(jg[name])
        err = np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-9)
        assert err < 1e-4, (name, err)


def test_single_step_carries_the_block_state():
    """Decoding one token at a time from the prefix's state gives the
    block's full-sequence output (conv shift register and SSM state)."""
    _, x, tp = _block_inputs(seed=5)
    xt = torch.from_numpy(x)
    full, _ = mamba_block(xt, tp, ssm_state=N)
    _, st = mamba_block(xt[:, :20], tp, ssm_state=N, use_kernel=True)
    outs = []
    for t in range(20, 32):
        y, st = mamba_block(xt[:, t:t + 1], tp, ssm_state=N, state=st,
                            single_step=True)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               full[:, 20:].numpy(), rtol=1e-4, atol=1e-5)


def test_causal_conv_is_the_reference_shifted_sum():
    from repro.models.ssm import _causal_conv as j_conv
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    pre = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for prefix in (None, pre):
        jo, jp = j_conv(jnp.asarray(x), jnp.asarray(w),
                        None if prefix is None else jnp.asarray(prefix))
        to, tpre = _causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                None if prefix is None
                                else torch.from_numpy(prefix))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(tpre.numpy(), np.asarray(jp))


def test_init_mamba_params_layout():
    gen = torch.Generator().manual_seed(0)
    p = t_init(gen, D_MODEL, DI, N, R, 4, torch.bfloat16)
    ref = init_mamba_params(jax.random.PRNGKey(0), D_MODEL, DI, N, R, 4,
                            jnp.bfloat16)
    assert set(p) == set(ref)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape, k
        assert str(p[k].dtype).split(".")[-1] == str(v.dtype), k
    # log(1..N) may differ by one float32 ulp between the two libraries
    np.testing.assert_allclose(p["a_log"].numpy(), np.asarray(ref["a_log"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(p["d_skip"].numpy(),
                                  np.asarray(ref["d_skip"]))
    assert float(p["dt_b"][0]) == float(ref["dt_b"][0])


# ------------------------------ the model ------------------------------ #
def _model(dtype):
    jcfg, tcfg = configs("falcon-mamba-7b", dtype=dtype)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, port_params(jp, tcfg)


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_model_logits_match_jax(dtype, tol):
    """Reduced falcon-mamba-7b: forward_train (both scan routes), prefill
    and three greedy decode steps, from converted weights."""
    jcfg, tcfg, jp, tp = _model(dtype)
    j_forward, j_prefill, j_decode = (
        jax.jit(functools.partial(fn, cfg=jcfg))
        for fn in (jtf.forward_train, jtf.prefill, jtf.decode_step))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jl, _ = j_forward(jp, batch={"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        for use_kernel in (False, True):
            tl, aux = forward_train(tp, tcfg,
                                    {"tokens": torch.from_numpy(toks)},
                                    use_kernel=use_kernel)
            assert aux == 0.0
            np.testing.assert_allclose(tl.float().numpy(), _f32(jl),
                                       rtol=tol, atol=tol)
        jlast, jcache = j_prefill(jp, batch={"tokens": jnp.asarray(toks)})
        tlast, tcache = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                                use_kernel=True)
        np.testing.assert_allclose(tlast.float().numpy(), _f32(jlast),
                                   rtol=tol, atol=tol)
        for key in ("conv", "h"):
            np.testing.assert_allclose(tcache[key].float().numpy(),
                                       _f32(jcache[key]), rtol=tol, atol=tol)
        assert int(tcache["pos"]) == int(jcache["pos"]) == 16
        nxt = toks[:, -1:]
        for _ in range(3):
            nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
            jlast, jcache = j_decode(jp, cache=jcache,
                                     batch={"tokens": jnp.asarray(nxt)})
            tlast, tcache = decode_step(tp, tcfg, tcache,
                                        {"tokens": torch.from_numpy(nxt)})
            np.testing.assert_allclose(tlast.float().numpy(), _f32(jlast),
                                       rtol=tol, atol=tol)
        assert int(tcache["pos"]) == 19


def test_prefill_and_decode_follow_the_teacher_forced_forward():
    """Decode logits equal the full forward's at each position (the same
    check chip_smoke.py makes on the card)."""
    _, tcfg, _, tp = _model("float32")
    rng = np.random.default_rng(8)
    seq = torch.from_numpy(rng.integers(0, tcfg.vocab_size, size=(2, 12))
                           .astype(np.int32))
    with torch.no_grad():
        full, _ = forward_train(tp, tcfg, {"tokens": seq}, use_kernel=True)
        last, cache = prefill(tp, tcfg, {"tokens": seq[:, :8]},
                              use_kernel=True)
        steps = [last]
        for t in range(8, 12):
            last, cache = decode_step(tp, tcfg, cache,
                                      {"tokens": seq[:, t:t + 1]})
            steps.append(last)
    got = torch.cat(steps, 1)
    torch.testing.assert_close(got, full[:, 7:], rtol=1e-4, atol=1e-4)


def test_ssm_state_is_a_named_pair():
    st = SSMState(conv=torch.zeros(1), h=torch.ones(1))
    assert st._fields == ("conv", "h") and float(st.h) == 1.0


def test_cpu_kernel_route_launches_nothing():
    _, x, tp = _block_inputs()
    ops.reset_launch_counts()
    mamba_block(torch.from_numpy(x), tp, ssm_state=N, use_kernel=True)
    assert not any(ops.launch_counts().values())
