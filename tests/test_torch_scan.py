"""The port's selective scan on the CPU against the JAX package: the
plain recurrence (``kernels/ref.py::selective_scan_ref``, the plain
version of all three CUDA scan kernels) and the chunked linear scan
(``models/scan_utils.py``) against the JAX oracle and the Pallas kernels
in interpret mode.  The CUDA kernels themselves are held against the
plain version on the GPU in tests/test_torch_gpu.py.

Tolerances are the reference's own (tests/test_kernels.py): 1e-4 in
float32, 5e-2 for bfloat16 inputs, and for each gradient a max-abs error
below 1e-4 of the reference gradient's max-abs value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ref import selective_scan_ref as jax_ref
from repro.kernels.selective_scan import (selective_scan as pallas_scan,
                                          selective_scan_trainable)
from repro.models.scan_utils import chunked_linear_scan as jax_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.ref import selective_scan_ref
from repro_torch.models.scan_utils import (chunked_linear_scan,
                                           linear_scan_step)

SWEEP = [
    (1, 32, 16, 8, 16, 16),
    (2, 64, 32, 8, 16, 32),
    (2, 128, 64, 16, 32, 64),
    (1, 64, 48, 16, 16, 16),
]


def _inputs(b, s, d, n, seed):
    """dt = softplus(normal), x, b, c, h0 normal, a = -exp(0.5 normal):
    the distribution of the reference's kernel tests."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)
    dt = np.log1p(np.exp(f(b, s, d))).astype(np.float32)
    a = -np.exp(0.5 * f(d, n)).astype(np.float32)
    return dt, f(b, s, d), f(b, s, n), f(b, s, n), a, f(b, d, n)


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _port_chunked(dt, x, b, c, a, h0, chunk):
    """The scan through the plain route of ``mamba_block``: the state
    expansion, the chunked linear scan and the contraction with c."""
    a_bar = torch.exp(dt[..., None] * a)
    b_bar = dt[..., None] * b[..., None, :] * x[..., None]
    h_all, h_fin = chunked_linear_scan(a_bar, b_bar, h0, chunk=chunk)
    return torch.einsum("bsdn,bsn->bsd", h_all, c), h_fin


@pytest.mark.parametrize("b,s,d,n,block_d,chunk", SWEEP)
def test_scan_matches_jax_oracle_and_pallas(b, s, d, n, block_d, chunk):
    arrays = _inputs(b, s, d, n, seed=b * s + d)
    jx = [jnp.asarray(a) for a in arrays]
    want_ref = jax_ref(*jx)
    want_pallas = pallas_scan(*jx, block_d=block_d, chunk=chunk,
                              interpret=True)
    got_ref = ops.selective_scan(*_t(arrays))
    got_chunked = _port_chunked(*_t(arrays), chunk=chunk)
    for got in (got_ref, got_chunked):
        for g, w_ref, w_pal in zip(got, want_ref, want_pallas):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_ref),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g.numpy(), np.asarray(w_pal),
                                       rtol=1e-4, atol=1e-4)


def test_scan_bf16_inputs_match_jax():
    dt, x, b, c, a, _ = _inputs(1, 32, 16, 8, seed=9)
    h0 = np.zeros((1, 16, 8), np.float32)
    bf = lambda arr: jnp.asarray(arr).astype(jnp.bfloat16)
    jx = [bf(dt), bf(x), bf(b), bf(c), jnp.asarray(a), jnp.asarray(h0)]
    want_pallas, _ = pallas_scan(*jx, block_d=16, chunk=16, interpret=True)
    want_ref, _ = jax_ref(*jx)
    tx = _t([dt, x, b, c], torch.bfloat16) + _t([a, h0])
    got, h_fin = ops.selective_scan(*tx)
    assert got.dtype == torch.bfloat16 and h_fin.dtype == torch.float32
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,s,d,n,block_d,chunk", SWEEP[:2])
def test_scan_gradients_match_jax_backward_kernel(b, s, d, n, block_d,
                                                  chunk):
    """Autograd of the port's plain recurrence (what the CUDA backward
    computes) against ``jax.grad`` of the Pallas trainable scan, for every
    input, on a loss that reaches y and h_final."""
    arrays = _inputs(b, s, d, n, seed=7 * b + s)
    w = np.random.default_rng(s).normal(size=(b, s, d)).astype(np.float32)

    def lk(*args):
        y, hf = selective_scan_trainable(*args, block_d, chunk, True)
        return jnp.sum(y * w) + 0.5 * jnp.sum(hf)

    want = jax.grad(lk, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in arrays])
    tx = [t.requires_grad_() for t in _t(arrays)]
    y, hf = ops.selective_scan(*tx, trainable=True)
    loss = (y * torch.from_numpy(w)).sum() + 0.5 * hf.sum()
    got = torch.autograd.grad(loss, tx)
    for g, r in zip(got, want):
        r = np.asarray(r)
        assert g.shape == r.shape
        err = np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-9)
        assert err < 1e-4, err


@pytest.mark.parametrize("s,chunk", [(32, 8), (64, 64), (40, 16)])
def test_chunked_linear_scan_matches_jax(s, chunk):
    """The generic recurrence h_t = a_t h_{t-1} + b_t, value and
    gradient; a ragged S (40 over chunks of 16) is the port's extension
    and is held against one JAX chunk."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 6, 3)).astype(np.float32)
    bb = rng.normal(size=(2, s, 6, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 6, 3)).astype(np.float32)
    jchunk = chunk if s % chunk == 0 else s
    scan = jax.jit(lambda *z: jax_chunked(*z, chunk=jchunk))
    jh, jf = scan(jnp.asarray(a), jnp.asarray(bb), jnp.asarray(h0))
    ta, tb, th = [t.requires_grad_() for t in _t([a, bb, h0])]
    h_all, h_fin = chunked_linear_scan(ta, tb, th, chunk=chunk)
    np.testing.assert_allclose(h_all.detach().numpy(), np.asarray(jh),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_fin.detach().numpy(), np.asarray(jf),
                               rtol=1e-5, atol=1e-5)
    jg = jax.jit(jax.grad(lambda *z: jnp.sum(scan(*z)[0]),
                          argnums=(0, 1, 2)))(jnp.asarray(a),
                                              jnp.asarray(bb),
                                              jnp.asarray(h0))
    tg = torch.autograd.grad(h_all.sum(), (ta, tb, th))
    for g, r in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    step = linear_scan_step(ta[:, 0], tb[:, 0], th)
    np.testing.assert_allclose(step.detach().numpy(),
                               h_all[:, 0].detach().numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------- CUDA kernel ------------------------------ #
def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: they never run the
    plain version behind the caller's back, and count no launch."""
    from repro_torch.kernels import selective_scan as ss
    arrays = _t(_inputs(1, 8, 4, 4, seed=0))
    before = ops.launch_counts()
    for fn in (ss.selective_scan, ss.selective_scan_fwd_ckpt,
               ss.selective_scan_trainable):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*arrays)
    with pytest.raises(ValueError, match="CUDA"):
        ss.selective_scan_bwd(*arrays[:5], torch.zeros(1, 1, 4, 4),
                              arrays[1], arrays[5])
    with pytest.raises(TypeError, match="float32"):
        ss.selective_scan_trainable(*[t.double() for t in arrays])
    assert ops.launch_counts() == before
