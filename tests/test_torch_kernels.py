"""The port's paged decode-attention kernel: its plain PyTorch version
against the JAX oracle and the Pallas kernel (interpret mode) on the
CPU.  The CUDA kernel itself is held against the plain version on the
GPU in tests/test_torch_gpu.py.

Tolerances are the reference's own (tests/test_paged_attention.py):
2e-5 in float32, 5e-2 in bfloat16.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.ref import paged_attention_ref as jax_ref
from repro_torch.kernels import ops

SWEEPS = [
    (2, 4, 2, 16, 8, 10, 3),
    (3, 8, 1, 32, 16, 12, 2),     # MQA
    (1, 4, 4, 64, 8, 6, 4),       # MHA (group = 1)
    (4, 8, 2, 128, 16, 24, 5),
]


def _inputs(b, h, hkv, d, bs, n, m, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n, bs, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(n, bs, hkv, d)).astype(np.float32)
    ids = rng.permutation(np.arange(1, n))[:b * m]
    bt = np.resize(ids, (b, m)).astype(np.int32)
    lengths = rng.integers(1, m * bs + 1, size=(b,)).astype(np.int32)
    return q, kp, vp, bt, lengths


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) if a.dtype == np.float32
            else jnp.asarray(a) for a in arrays]


# ------------------------- plain version vs JAX ------------------------ #
@pytest.mark.parametrize("b,h,hkv,d,bs,n,m", SWEEPS)
def test_plain_matches_jax_oracle_and_pallas(b, h, hkv, d, bs, n, m):
    arrays = _inputs(b, h, hkv, d, bs, n, m, seed=b * 31 + n)
    got = ops.paged_attention(*_torch(*arrays)).numpy()
    want_ref = np.asarray(jax_ref(*_jax(*arrays)))
    want_pallas = np.asarray(pallas_paged(*_jax(*arrays), interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=2e-5, atol=2e-5)


def test_plain_bf16_matches_jax():
    arrays = list(_inputs(2, 4, 2, 32, 8, 8, 2, seed=7))
    arrays[3] = np.asarray([[1, 2], [3, 4]], np.int32)
    arrays[4] = np.asarray([9, 16], np.int32)
    got = ops.paged_attention(*_torch(*arrays, dtype=torch.bfloat16))
    want = pallas_paged(*_jax(*arrays, dtype=jnp.bfloat16), interpret=True)
    ref = jax_ref(*_jax(*arrays, dtype=jnp.bfloat16))
    for w in (want, ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=5e-2, atol=5e-2)


def test_plain_short_rows_ignore_stale_blocks():
    """Slots past a row's length must not leak into the output even
    when the pool holds other requests' live data there."""
    q, kp, vp, _, _ = _inputs(2, 4, 2, 16, 8, 6, 2, seed=3)
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    lengths = np.asarray([3, 11], np.int32)
    base = ops.paged_attention(*_torch(q, kp, vp, bt, lengths))
    kp2, vp2 = kp.copy(), vp.copy()
    for arr in (kp2, vp2):
        arr[2] = 99.0
        arr[4, 3:] = -99.0
        arr[5] = 99.0
    again = ops.paged_attention(*_torch(q, kp2, vp2, bt, lengths))
    np.testing.assert_allclose(base.numpy(), again.numpy(),
                               rtol=1e-6, atol=1e-6)
    pallas = pallas_paged(*_jax(q, kp2, vp2, bt, lengths), interpret=True)
    np.testing.assert_allclose(again.numpy(), np.asarray(pallas),
                               rtol=2e-5, atol=2e-5)


def test_length_zero_row_matches_pallas_zeros():
    """A length-0 row: the Pallas kernel (and the CUDA kernel) give
    zeros; the oracles are all-masked and give NaN, so only the live
    rows are compared with them."""
    q, kp, vp, bt, lengths = _inputs(3, 4, 2, 16, 8, 8, 2, seed=11)
    lengths[1] = 0
    pallas = np.asarray(pallas_paged(*_jax(q, kp, vp, bt, lengths),
                                     interpret=True))
    np.testing.assert_array_equal(pallas[1], 0.0)
    got = ops.paged_attention(*_torch(q, kp, vp, bt, lengths)).numpy()
    assert np.isnan(got[1]).all()
    live = [0, 2]
    np.testing.assert_allclose(got[live], pallas[live], rtol=2e-5,
                               atol=2e-5)


# ---------------------------- CUDA kernel ------------------------------ #
def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper itself takes CUDA tensors only: it never runs
    the plain version behind the caller's back."""
    from repro_torch.kernels.paged_attention import paged_attention
    arrays = _torch(*_inputs(2, 4, 2, 16, 8, 10, 3, seed=0))
    before = paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*arrays)
    assert paged_attention.launches == before
