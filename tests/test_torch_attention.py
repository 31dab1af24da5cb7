"""The port's attention against the JAX package's, on the same numpy
inputs: the flash kernel's plain version (``flash_attention_ref``)
against the Pallas kernel in interpret mode and the jnp oracle, its
log-sum-exp against float64, the plain flash backward against
``jax.grad`` of the oracle, and ``layers.attention`` on both of its
branches (direct, with ``q_offset``/``kv_len``; chunked, at S 4096)
against ``repro.models.layers.attention``, forward and gradient.

Tolerances: 2e-5 in float32 and 5e-2 in bfloat16 (the reference's
``tests/test_kernels.py``); gradients 1e-4 of the reference gradient's
max-abs in float32 (sums over S in other orders); lse 1e-5 against
float64.  The CUDA kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import flash_attention_ref as j_oracle
from repro.models import layers as jl
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models import layers as tl

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


SWEEP = [(1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 256, 64),
         (2, 4, 4, 128, 128)]


@pytest.mark.parametrize("b,h,hkv,s,d", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_and_oracle(b, h, hkv, s, d, causal):
    """The sweep of the reference's test_flash_attention_sweep."""
    q, k, v = _qkv(b, h, hkv, s, d, seed=b * s + h)
    got, lse = flash_attention_ref(*_t((q, k, v)), causal=causal)
    want = pallas_flash(q, k, v, causal=causal, block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = j_oracle(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32


@pytest.mark.parametrize("window", [32, 128])
def test_plain_flash_window_matches_pallas(window):
    q, k, v = _qkv(1, 4, 4, 256, 64, seed=window)
    got, _ = flash_attention_ref(*_t((q, k, v)), causal=True, window=window)
    want = pallas_flash(q, k, v, causal=True, window=window, block_q=64,
                        block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_oracle(q, k, v, True, window)), **F32)


def test_plain_flash_bf16_matches_pallas():
    q, k, v = _qkv(1, 2, 2, 128, 64, seed=1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got, _ = flash_attention_ref(*_t((q, k, v), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = pallas_flash(jq, jk, jv, block_q=64, block_k=64)
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16)
    np.testing.assert_allclose(got.float().numpy(),
                               _f32(j_oracle(jq, jk, jv)), **BF16)


@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (False, None, 4),
                                               (True, 48, 1)])
def test_plain_flash_lse_matches_float64(causal, window, hkv):
    b, h, s, d = 2, 4, 192, 32
    q, k, v = _qkv(b, h, hkv, s, d, seed=7)
    _, lse = flash_attention_ref(*_t((q, k, v)), causal=causal,
                                 window=window)
    group = h // hkv
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       np.repeat(k, group, axis=1).astype(np.float64))
    logits /= np.sqrt(d)
    qi, ki = np.arange(s)[:, None], np.arange(s)[None, :]
    mask = np.ones((s, s), bool)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = np.where(mask, logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
    (2, 4, 4, 256, 32, True, None),
    (1, 4, 4, 128, 64, False, None),
    (2, 4, 2, 192, 32, True, None),       # GQA
    (1, 8, 1, 256, 64, True, None),       # MQA
    (1, 4, 2, 256, 32, True, 48),         # sliding window
    (1, 2, 2, 2048 + 1024, 16, True, 1500),   # three chunks, pairs skipped
])
def test_plain_flash_backward_matches_jax_grad(b, h, hkv, s, d, causal,
                                               window):
    q, k, v = _qkv(b, h, hkv, s, d, seed=s + h)
    do = np.random.default_rng(99).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda q_, k_, v_: jnp.sum(
        j_oracle(q_, k_, v_, causal, window) * do), argnums=(0, 1, 2))(
            q, k, v)
    tq, tk, tv = _t((q, k, v))
    o, lse = flash_attention_ref(tq, tk, tv, causal, window)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  causal, window)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (name, err)


def test_plain_flash_backward_matches_autograd_of_plain_forward():
    q, k, v = _qkv(1, 6, 2, 320, 32, seed=3)
    do = torch.from_numpy(np.random.default_rng(5).normal(
        size=q.shape).astype(np.float32))
    leaves = [t.requires_grad_() for t in _t((q, k, v))]
    o, lse = flash_attention_ref(*leaves, causal=True, window=100)
    (o * do).sum().backward()
    got = flash_attention_bwd_ref(*[t.detach() for t in leaves], o.detach(),
                                  lse.detach(), do, True, 100)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-5)


def test_rows_with_every_key_masked_give_zeros_not_nan():
    """Non-causal with window 0 leaves the last row no key: the Pallas
    ``_finalize`` guard gives 0 there; the gradient is 0, not NaN."""
    q, k, v = _qkv(1, 2, 2, 128, 32, seed=11)
    want = pallas_flash(q, k, v, causal=False, window=0, block_q=64,
                        block_k=64)
    leaves = [t.requires_grad_() for t in _t((q, k, v))]
    o, lse = flash_attention_ref(*leaves, causal=False, window=0)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), **F32)
    assert torch.all(o[:, :, -1] == 0) and torch.all(lse[:, :, -1] == -np.inf)
    assert torch.isfinite(lse[:, :, :-1]).all()
    do = torch.ones_like(o)
    grads = flash_attention_bwd_ref(*[t.detach() for t in leaves],
                                    o.detach(), lse.detach(), do, False, 0)
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.all(grads[0][:, :, -1] == 0)
    o.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


def test_ops_flash_attention_on_cpu_is_the_plain_version():
    q, k, v = _t(_qkv(1, 4, 2, 128, 32, seed=4))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, causal=True, window=None)
    assert torch.equal(got, flash_attention_ref(q, k, v)[0])
    assert ops.launch_counts()["flash_attention"] == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _t(_qkv(1, 2, 2, 64, 32, seed=2))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


# ------------------------------------------------------------------ #
# layers.attention, [B, S, H, D]
# ------------------------------------------------------------------ #
def _bshd(b, s, h, hkv, d, seed, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    return (rng.normal(size=(b, s, h, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("s,skv,q_offset,kv_len,causal,window", [
    (16, 16, 0, None, True, None),        # short self-attention
    (16, 16, 0, None, False, None),
    (24, 24, 0, None, True, 8),
    (1, 40, 17, 18, True, None),          # decode over a cache
    (1, 40, 39, 40, True, None),          # a full cache
    (4, 40, 20, 24, True, None),          # a chunk over a cache
    (1, 40, 30, 31, True, 16),            # windowed decode
])
@pytest.mark.parametrize("probs_bf16", [False, True])
def test_direct_attention_matches_jax(s, skv, q_offset, kv_len, causal,
                                      window, probs_bf16):
    q, k, v = _bshd(2, s, 4, 2, 16, seed=s + skv, skv=skv)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len, probs_bf16=probs_bf16)
    got = tl.attention(*_t((q, k, v)), causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len,
                       probs_bf16=probs_bf16)
    tol = BF16 if probs_bf16 else F32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_direct_attention_bf16_inputs_match_jax():
    q, k, v = _bshd(2, 12, 4, 4, 32, seed=21)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jl.attention(jq, jk, jv)
    got = tl.attention(*_t((q, k, v), torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **BF16)


CHUNKED = (1, 4096, 4, 2, 16)     # B, S, H, Hkv, D: S > 2048 -> chunked


@pytest.mark.parametrize("window", [None, 1500])
def test_chunked_attention_forward_and_grad_match_jax(window):
    """S 4096 takes the chunked branch in both packages; on the CPU the
    port's default and its kernel route both run the plain chunked path,
    launch nothing, and hold to the reference, forward and gradient."""
    b, s, h, hkv, d = CHUNKED
    q, k, v = _bshd(b, s, h, hkv, d, seed=31)
    do = np.random.default_rng(32).normal(size=q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        return jnp.sum(jl.attention(q_, k_, v_, window=window) * do)
    jout = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        window=window)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for use_kernel in (None, True):
        ops.reset_launch_counts()
        leaves = [t.requires_grad_() for t in _t((q, k, v))]
        out = tl.attention(*leaves, window=window, use_kernel=use_kernel)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   **F32)
        (out * torch.from_numpy(do)).sum().backward()
        for leaf, w in zip(leaves, jgrads):
            w = np.asarray(w)
            err = np.abs(leaf.grad.numpy() - w).max() / np.abs(w).max()
            assert err < 1e-4, (use_kernel, err)
        assert not any(ops.launch_counts().values())


def test_chunked_attention_probs_bf16_matches_jax():
    b, s, h, hkv, d = CHUNKED
    q, k, v = _bshd(b, s, h, hkv, d, seed=41)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        probs_bf16=True)
    got = tl.attention(*_t((q, k, v)), probs_bf16=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BF16)
    plain = tl.attention(*_t((q, k, v)), probs_bf16=False)
    assert not torch.equal(got, plain)      # the lever changes the result


def test_kernel_route_refuses_probs_bf16():
    q, k, v = _t(_bshd(*CHUNKED[:1], 2048 + 1024, 2, 2, 16, seed=5))
    with pytest.raises(NotImplementedError, match="probs_bf16"):
        tl.attention(q, k, v, probs_bf16=True, use_kernel=True)


def test_chunked_branch_needs_whole_kv_chunks():
    """The reference asserts S % 1024 == 0 on its chunked branch; the
    port raises on both routes."""
    q, k, v = _t(_bshd(1, 2048 + 64, 2, 2, 16, seed=6))
    for use_kernel in (False, True):
        with pytest.raises(ValueError, match="chunk"):
            tl.attention(q, k, v, use_kernel=use_kernel)
