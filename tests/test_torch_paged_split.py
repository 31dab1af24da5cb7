"""The paged kernel's split-KV plan on the CPU: the plain split version
(``paged_attention_split_ref``, the kernel's partials and their merge)
against the JAX Pallas kernel in interpret mode and the plain version,
and the host planner (``plan_splits``) that picks the splits.

Tolerances are the reference's own (tests/test_paged_attention.py):
2e-5 in float32, 5e-2 in bfloat16.
"""

import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import (paged_attention_ref,
                                     paged_attention_split_ref)
from torch_util import CPU, configs

TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

CASES = [
    # (label, b, h, hkv, d, bs, n, m, split_blocks, lengths)
    ("splits past the length", 3, 4, 2, 16, 8, 40, 12, 2, [5, 30, 96]),
    ("length-0 row", 3, 4, 2, 16, 8, 40, 12, 3, [0, 17, 50]),
    ("split and block boundaries", 6, 4, 2, 16, 8, 80, 8, 3,
     [24, 25, 23, 48, 8, 9]),
    ("GQA group 7", 2, 14, 2, 32, 16, 20, 6, 2, [33, 96]),
    ("head dim 160", 2, 4, 2, 160, 16, 12, 4, 1, [17, 64]),
    ("block size 16, one block a split", 2, 8, 8, 64, 16, 12, 5, 1,
     [16, 79]),
    ("block size 64", 2, 4, 2, 32, 64, 8, 3, 1, [64, 130]),
]


def _inputs(b, h, hkv, d, bs, n, m, lengths, seed):
    """Numpy inputs; each row owns distinct blocks, so every slot past a
    length holds another row's or a free block's live data."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n, bs, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(n, bs, hkv, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n))[:b * m].reshape(b, m)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lengths, np.int32)


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(JAX_DTYPE[dtype]) if a.dtype == np.float32
            else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_ref_matches_pallas(case, dtype):
    _, b, h, hkv, d, bs, n, m, split_blocks, lengths = case
    arrays = _inputs(b, h, hkv, d, bs, n, m, lengths, seed=b * 7 + d)
    got = paged_attention_split_ref(*_torch(arrays, dtype), split_blocks)
    assert got.dtype == dtype and got.shape == (b, h, d)
    want = np.asarray(pallas_paged(*_jax(arrays, dtype), interpret=True),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    live = torch.from_numpy(arrays[4] > 0)
    assert torch.all(got[~live] == 0)
    plain = paged_attention_ref(*_torch(arrays, dtype))
    torch.testing.assert_close(got[live].float(), plain[live].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_split_ref_ignores_stale_slots():
    """Clobbering every slot at or past each length (the tail of the last
    block and the rest of the table) leaves every split's result equal."""
    q, kp, vp, bt, lengths = _inputs(3, 4, 2, 16, 8, 40, 12, [5, 30, 96],
                                     seed=3)
    base = paged_attention_split_ref(*_torch((q, kp, vp, bt, lengths),
                                             torch.float32), 2)
    kp2, vp2 = kp.copy(), vp.copy()
    for row, n in enumerate(lengths):
        for j, blk in enumerate(bt[row]):
            lo = max(n - j * 8, 0)
            if lo < 8:
                kp2[blk, lo:] = 1e4
                vp2[blk, lo:] = -1e4
    again = paged_attention_split_ref(*_torch((q, kp2, vp2, bt, lengths),
                                              torch.float32), 2)
    assert torch.equal(base, again)


def test_empty_block_table_gives_zeros():
    """A table of no columns: every row has no token, so zeros (the CUDA
    wrapper returns the same without a launch; tests/test_torch_gpu.py)."""
    from repro_torch.kernels import ops
    q, kp, vp, _, lengths = _torch(_inputs(2, 4, 2, 16, 8, 10, 1, [0, 0],
                                           seed=4), torch.float32)
    empty = torch.zeros((2, 0), dtype=torch.int32)
    got = ops.paged_attention(q, kp, vp, empty, lengths)
    assert got.shape == q.shape and torch.equal(got, torch.zeros_like(q))


# ------------------------------ the planner ------------------------------ #
def test_split_plan_reads_no_tensor_data():
    """The planner takes host integers only; on tensors it reads shapes,
    which meta tensors (no data at all) have."""
    assert list(inspect.signature(pa.plan_splits).parameters) == [
        "m", "bs", "b", "hkv", "slots"]
    meta = torch.device("meta")
    q = torch.empty((16, 56, 128), dtype=torch.bfloat16, device=meta)
    kp = torch.empty((2400, 16, 8, 128), dtype=torch.bfloat16, device=meta)
    bt = torch.empty((16, 257), dtype=torch.int32, device=meta)
    assert pa.split_plan(q, kp, bt, 396) == pa.plan_splits(257, 16, 16, 8,
                                                           396)


@pytest.mark.parametrize("slots", [1, 132, 792])
@pytest.mark.parametrize("bs", [1, 8, 16, 64])
def test_split_plan_covers_every_block_once(bs, slots):
    for m in (1, 2, 7, 25, 257, 1000, 4096, 70000):
        for b, hkv in ((1, 1), (8, 36), (16, 8), (64, 64)):
            blocks, n_split = pa.plan_splits(m, bs, b, hkv, slots)
            assert 1 <= blocks <= pa.MAX_SPLIT_BLOCKS
            assert 1 <= n_split <= pa.MAX_SPLITS
            owner = np.zeros(m, np.int64)
            for s in range(n_split):
                lo, hi = s * blocks, min(m, (s + 1) * blocks)
                assert lo < hi, (m, bs, b, hkv, slots, s)   # no empty split
                owner[lo:hi] += 1
            assert np.all(owner == 1), (m, bs, b, hkv, slots)


def test_split_plan_rules():
    """chip_smoke.py's shapes at the resident blocks measured on an H100
    (132 SMs x 6 paged_simt blocks at D 64, x 3 paged_mma blocks at D
    128): full rows fill about one wave, a split spans at most 1024
    tokens, at least 64 where the row has them, and one split when the
    table is short."""
    assert pa.plan_splits(25, 16, 8, 36, 792) == (9, 3)
    assert pa.plan_splits(257, 16, 16, 36, 792) == (52, 5)
    assert pa.plan_splits(257, 16, 16, 8, 396) == (52, 5)
    assert pa.plan_splits(3, 16, 1, 1, 792) == (3, 1)
    for m in (4, 40, 400, 4000):
        blocks, n_split = pa.plan_splits(m, 8, 1, 1, 792)
        assert blocks * 8 >= min(pa.MIN_SPLIT_TOKENS, m * 8)
        assert n_split == 1 or blocks * 8 <= pa.MAX_SPLIT_TOKENS


def test_split_plan_is_fixed_for_one_server(monkeypatch):
    """Every decode step of one server plans the same split: the server
    always passes its full batch and max_blocks_per_seq columns."""
    from repro_torch.models import paged
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingServer, Request
    _, tcfg = configs("minicpm-2b")
    plans = []
    plain = paged.paged_attention

    def record(q, kp, vp, bt, lengths):
        plans.append(pa.split_plan(q, kp, bt, 792))
        return plain(q, kp, vp, bt, lengths)

    monkeypatch.setattr(paged, "paged_attention", record)
    srv = ContinuousBatchingServer(tcfg, init_params(tcfg, seed=0,
                                                     device=CPU),
                                   3, max_len=48, block_size=4,
                                   prefill_chunk=8, device="cpu")
    srv.use_kernel = True      # the CUDA route's call, on the plain path
    rng = np.random.default_rng(0)
    for rid in range(5):
        prompt = rng.integers(0, tcfg.vocab_size, 3 + 4 * rid)
        srv.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                           max_new_tokens=4 + rid))
    srv.run()
    snap = srv.snapshot()
    assert len(plans) == snap.decode_steps * tcfg.num_layers > 0
    assert len(set(plans)) == 1, set(plans)
