"""The port's transformer primitives against the JAX package's, on the
same numpy inputs, in float32 (tolerance 1e-6).  Norm weights are random
and non-zero, which pins the ``(1 + weight)`` scale convention; the RoPE
check pins the half-split pairing."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed):
    return np.random.default_rng(seed)


def test_rms_norm_one_plus_weight():
    rng = _rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    got = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    want = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("positions_2d", [True, False])
def test_apply_rope_half_split(positions_2d):
    rng = _rng(1)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    if positions_2d:
        pos = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    else:
        pos = np.arange(3, 9, dtype=np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swiglu():
    rng = _rng(2)
    d, f = 64, 128
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    wg = (rng.normal(size=(d, f)) * d ** -0.5).astype(np.float32)
    wu = (rng.normal(size=(d, f)) * d ** -0.5).astype(np.float32)
    wd = (rng.normal(size=(f, d)) * f ** -0.5).astype(np.float32)
    got = tl.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    want = jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
