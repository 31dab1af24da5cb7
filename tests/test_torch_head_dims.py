"""The head dims the flash kernel takes, against the configs that reach it
and against the JAX package at the two that are not powers of two.

* every config of the dense, MoE, hybrid and encoder-decoder families
  resolves to a head dim in ``flash_attention.HEAD_DIMS`` (their
  self-attention over more than 2048 positions goes to the kernel on a
  CUDA tensor, and the kernel raises on any other head dim;
  ``recurrentgemma-9b``'s local attention is at 256, held against the
  Pallas kernel in ``test_torch_hybrid.py``);
* the kernel's plain version at D 96 (``phi3-mini-3.8b``) and D 160
  (``mistral-nemo-12b``), GQA and causal, against the Pallas
  ``flash_attention`` in interpret mode, float32 within 2e-5 (the
  reference's ``tests/test_kernels.py``);
* the plain flash backward at D 96 against ``jax.grad`` of the
  reference's ``_chunked_attention``, each gradient within 1e-4 of its
  max-abs (float32 sums over S in other orders).

The CUDA kernel at these head dims is held to the plain version on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jl
from repro_torch.configs import all_configs
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

FLASH_FAMILIES = ("dense", "moe", "hybrid", "encdec")
F32 = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("arch", sorted(
    name for name, cfg in all_configs().items()
    if cfg.family in FLASH_FAMILIES))
def test_config_head_dim_is_taken_by_the_flash_kernel(arch):
    cfg = all_configs()[arch]
    assert cfg.resolved_head_dim in HEAD_DIMS, (arch, cfg.resolved_head_dim)


@pytest.mark.parametrize("d,h,hkv", [(96, 4, 2), (160, 4, 1)])
def test_plain_flash_matches_pallas_at_96_and_160(d, h, hkv):
    q, k, v = _qkv(1, h, hkv, 256, d, seed=d)
    got, lse = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=True)
    want = pallas_flash(q, k, v, causal=True, block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert lse.shape == (1, h, 256) and torch.isfinite(lse).all()


def test_plain_flash_backward_matches_jax_grad_of_chunked_at_96():
    b, h, hkv, s, d = 1, 4, 2, 256, 96
    q, k, v = _qkv(b, h, hkv, s, d, seed=5)
    do = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    group = h // hkv

    def loss(q_, k_, v_):
        o = jl._chunked_attention(q_, jnp.repeat(k_, group, axis=1),
                                  jnp.repeat(v_, group, axis=1), True, None,
                                  chunk=64)
        return jnp.sum(o * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = flash_attention_ref(tq, tk, tv, True, None)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, torch.from_numpy(do),
                                  True, None)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err < 1e-4, (name, err)
