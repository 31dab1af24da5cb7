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


# ------------------- multi_add and matmul_tiled (rows 2-3) -------------- #
@pytest.mark.parametrize("k", [2, 3, 8, 17])
@pytest.mark.parametrize("n", [128, 512, 1000, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_add_plain_matches_pallas_and_oracle(k, n, dtype):
    """tests/test_kernels.py::test_multi_add_sweep's shapes; the Pallas
    kernel in interpret mode and the jnp oracle.  Tolerances: float32
    sums in another order (1e-6, the reference's), bfloat16 one rounding
    of the float32 sum, at most one bf16 ulp apart (2e-2, the
    reference's)."""
    from repro.kernels.multi_add import multi_add as pallas_multi_add
    from repro.kernels.ref import multi_add_ref as jax_multi_add_ref
    x = np.random.default_rng(k * n).normal(size=(k, n)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ops.multi_add(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == (n,)
    xj = jnp.asarray(x).astype(jdt)
    tol = 1e-6 if dtype == "float32" else 2e-2
    for want in (pallas_multi_add(xj, interpret=True), jax_multi_add_ref(xj)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [(16, 24, 40), (130, 70, 260),
                                   (1, 8, 3), (128, 256, 256),
                                   (33, 17, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_tiled_plain_matches_pallas(m, k, n, dtype):
    """Ragged M and N (the Pallas kernel pads them): 2e-5 in float32
    (another BLAS order), one bf16 ulp of the result in bfloat16."""
    from repro.kernels.fused_matmul_rs import matmul_tiled as pallas_mm
    rng = np.random.default_rng(m * 131 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = ops.matmul_tiled(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (m, n)
    want = np.asarray(pallas_mm(jnp.asarray(x).astype(jdt),
                                jnp.asarray(w).astype(jdt),
                                interpret=True), np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    else:
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got.float().numpy() - want) <= ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_tiled_gradient_matches_custom_vjp(dtype):
    """The plain version's autograd gradient is the reference's dense
    backward (``_mm_bwd``): float32 products, cast to each input's
    dtype."""
    import jax
    from repro.kernels.fused_matmul_rs import matmul_tiled as pallas_mm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(24, 40)).astype(np.float32)
    w = rng.normal(size=(40, 36)).astype(np.float32)
    g = rng.normal(size=(24, 36)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    out = ops.matmul_tiled(xt, wt)
    out.backward(torch.from_numpy(g).to(tdt))
    _, vjp = jax.vjp(lambda a, b: pallas_mm(a, b, interpret=True),
                     jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    dx, dw = vjp(jnp.asarray(g).astype(jdt))
    tol = 2e-5 if dtype == "float32" else 2e-2
    for got, want in ((xt.grad, dx), (wt.grad, dw)):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol * 10)


def test_fused_matmul_rs_oracle_matches_jax():
    from repro.kernels.ref import fused_matmul_rs_ref as jax_fused_ref
    from repro_torch.kernels.ref import fused_matmul_rs_ref
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 16, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6, 10)).astype(np.float32)
    got = fused_matmul_rs_ref(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jax_fused_ref(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == (4, 4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["multi_add", "matmul_tiled"])
def test_new_cuda_wrappers_refuse_cpu_tensors(name):
    """The launch wrappers take CUDA tensors only and count nothing when
    they refuse."""
    from repro_torch.kernels.matmul_tiled import matmul_tiled_cuda
    from repro_torch.kernels.multi_add import multi_add
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if name == "multi_add":
            multi_add(torch.zeros(3, 8))
        else:
            matmul_tiled_cuda(torch.zeros(4, 8), torch.zeros(8, 2))
    assert ops.launch_counts() == before
