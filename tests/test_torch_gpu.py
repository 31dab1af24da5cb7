"""The port's CUDA kernels on the GPU, against their plain PyTorch
versions (marked ``gpu``; each test skips without a GPU and ``nvcc``).

This file imports torch, numpy and the port only, so it runs on a GPU
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in float32 and 5e-2 in bfloat16 for the paged kernel
(the reference's own), and in bfloat16 also element by element within
one bf16 ulp (+ 1e-5) of the plain version's float32 output; 2e-4 for
float32 model logits; for the scan kernels 1e-4 in float32, 5e-2 with
bfloat16 inputs, and each gradient's max-abs error below 1e-4 of the
plain gradient's max-abs (the reference's tests/test_kernels.py bounds).
``multi_add`` adds in the plain version's order, so it is held bitwise;
``matmul_tiled`` within 1e-5 (float32) and 1e-2 (bfloat16, one bf16 ulp)
of the plain product's max-abs. The collective tests use integer-valued
inputs (exact in any order); the NCCL test skips below two cards.
``flash_attention`` within 2e-5 (float32) and 5e-2 (bfloat16) of its
plain version, lse within 1e-4, and its gradient (plain backward) within
1e-4 of autograd's max-abs.  The MoE FFN (plain products, no kernel of
its own) on CUDA within 1e-5 of the CPU in float32, and bitwise equal
on a second call.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.models import decode_step_paged, forward_paged, init_pages
from repro_torch.models import init_params

TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels run only there)")
    from repro_torch.kernels import build
    try:
        build.find_nvcc()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_within_bf16_ulp(got, want_f):
    """A bf16 output, element by element, within one bf16 ulp of the
    float32 plain output at that element, plus 1e-5 (rounding takes half
    an ulp; the rest covers a value that crosses a power of two and the
    float32 sums' own difference near 0)."""
    e = torch.floor(torch.log2(want_f.abs().clamp_min(2.0 ** -126)))
    err = (got.float() - want_f).abs() / (torch.exp2(e - 7) + 1e-5)
    assert float(err.max()) <= 1.0, float(err.max())


def _case(b, h, hkv, d, bs, n, m, dtype, device, seed=5):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(n, bs, hkv, d)).astype(np.float32))
    vp = torch.from_numpy(rng.normal(size=(n, bs, hkv, d)).astype(np.float32))
    ids = rng.permutation(np.arange(1, n))[:b * m]
    bt = torch.from_numpy(np.resize(ids, (b, m)).astype(np.int32))
    lengths = rng.integers(1, m * bs + 1, size=(b,)).astype(np.int32)
    lengths[0] = 0                        # a length-0 row gives zeros
    return ([t.to(dtype).to(device) for t in (q, kp, vp)]
            + [bt.to(device), torch.from_numpy(lengths).to(device)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,d,bs,n,m", [
    (2, 4, 2, 16, 8, 10, 3),
    (3, 8, 1, 32, 16, 12, 2),        # MQA
    (4, 8, 2, 128, 16, 24, 5),
    (8, 36, 36, 64, 16, 201, 25),    # minicpm-2b decode
    (4, 32, 8, 128, 16, 64, 8),      # mistral-nemo GQA
    (2, 32, 32, 96, 16, 16, 4),      # phi3 head dim
    (2, 8, 8, 256, 64, 8, 3),        # the largest head dim and block
    (2, 16, 4, 80, 16, 12, 4),       # GQA at a head dim without paged_mma
    (4, 14, 2, 128, 16, 64, 8),      # yi-34b's heads a rank at TP-4
])
def test_cuda_kernel_matches_plain(cuda_device, dtype, b, h, hkv, d, bs,
                                   n, m):
    q, kp, vp, bt, lengths = _case(b, h, hkv, d, bs, n, m, dtype,
                                   cuda_device)
    ops.reset_launch_counts()
    got = ops.paged_attention(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == 1
    want = paged_attention_ref(q, kp, vp, bt, lengths)
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got[1:].float(), want[1:].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == torch.bfloat16:
        want_f = paged_attention_ref(q.float(), kp.float(), vp.float(), bt,
                                     lengths)
        _assert_within_bf16_ulp(got[1:], want_f[1:])


def _paged_rows(b, h, hkv, d, bs, n, lengths, dtype, device, seed=9,
                m=None):
    """A case with the given lengths: each row owns distinct blocks, then
    one more block of live data past its length (a stale block), then
    block 0 up to ``m`` columns."""
    rng = np.random.default_rng(seed)
    need = [-(-n_tok // bs) for n_tok in lengths]
    m = max(m or 0, max(need) + 1)
    assert sum(need) + b < n, "pool too small"
    ids = list(rng.permutation(np.arange(1, n)))
    bt = np.zeros((b, m), np.int32)
    for row, k in enumerate(need):
        bt[row, :k + 1] = [ids.pop() for _ in range(k + 1)]
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(dtype).to(device)
    return (f(b, h, d), f(n, bs, hkv, d), f(n, bs, hkv, d),
            torch.from_numpy(bt).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


def _check_paged(q, kp, vp, bt, lengths):
    """The kernel against the plain version and the plain split version
    (at the wrapper's own plan): tolerance (bf16: also within one bf16 ulp
    of both versions' float32 outputs), zeros for length-0 rows, one
    launch, bitwise equal on a second call.  Returns the output."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attention_split_ref
    ops.reset_launch_counts()
    got = ops.paged_attention(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_attention"] == 1
    assert torch.equal(got, ops.paged_attention(q, kp, vp, bt, lengths))
    tol = TOL[q.dtype]
    live = lengths > 0
    assert torch.all(got[~live] == 0)
    want = paged_attention_ref(q, kp, vp, bt, lengths)
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=tol, atol=tol)
    slots = pa.slots(q.device.index, q.dtype, q.shape[1] // kp.shape[2],
                     q.shape[2])
    split_blocks, _ = pa.split_plan(q, kp, bt, slots)
    split = paged_attention_split_ref(q, kp, vp, bt, lengths, split_blocks)
    torch.testing.assert_close(got.float(), split.float(), rtol=tol,
                               atol=tol)
    if q.dtype == torch.bfloat16:
        f32 = (q.float(), kp.float(), vp.float(), bt, lengths)
        _assert_within_bf16_ulp(got[live],
                                paged_attention_ref(*f32)[live])
        _assert_within_bf16_ulp(got, paged_attention_split_ref(
            *f32, split_blocks))
    return got


LONG_LENGTHS = [256 * k - 3 * (k % 4) for k in range(1, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,d", [(36, 36, 64), (56, 8, 128)],
                         ids=["minicpm-2b", "yi-34b"])
def test_paged_kernel_long_context(cuda_device, h, hkv, d):
    """chip_smoke.py's long-context decode shapes: 16 rows of 253 ... 4096
    tokens in a pool of 2400 blocks of 16, bf16."""
    _check_paged(*_paged_rows(16, h, hkv, d, 16, 2400, LONG_LENGTHS,
                              torch.bfloat16, cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,hkv,d", [(36, 36, 64), (56, 8, 128)],
                         ids=["group-1", "group-7"])
def test_paged_kernel_lengths_at_split_boundaries(cuda_device, dtype, h,
                                                  hkv, d):
    from repro_torch.kernels import paged_attention as pa
    b, bs, m = 7, 16, 257
    split_blocks, n_split = pa.plan_splits(
        m, bs, b, hkv, pa.slots(0, dtype, h // hkv, d))
    assert n_split > 1
    span = split_blocks * bs
    lengths = [span, span + 1, span - 1, 2 * span, 2 * span + bs, bs, 0]
    _check_paged(*_paged_rows(b, h, hkv, d, bs, 1200, lengths, dtype,
                              cuda_device, m=m))


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,d", [(36, 36, 64), (56, 8, 128)],
                         ids=["group-1", "group-7"])
def test_paged_kernel_large_table_short_rows(cuda_device, h, hkv, d):
    """M 1024 columns, rows of at most 40 tokens: most splits start past
    their length and exit at once."""
    _check_paged(*_paged_rows(6, h, hkv, d, 16, 64, [3, 0, 17, 40, 1, 16],
                              torch.bfloat16, cuda_device, m=1024))


@pytest.mark.gpu
@pytest.mark.parametrize("h,hkv,d", [(36, 36, 64), (56, 8, 128)],
                         ids=["group-1", "group-7"])
def test_paged_kernel_ignores_stale_slots(cuda_device, h, hkv, d):
    """Every slot past each length (the tail of the last block, the stale
    block, block 0 of the padded columns) clobbered: the output must not
    move by a bit."""
    bs = 16
    lengths = [1, 0, 37, 100, 157, 211, 290, 383]
    q, kp, vp, bt, lens = _paged_rows(8, h, hkv, d, bs, 201, lengths,
                                      torch.bfloat16, cuda_device, m=25)
    got = _check_paged(q, kp, vp, bt, lens)
    kp2, vp2 = kp.clone(), vp.clone()
    for row, n_tok in enumerate(lengths):
        for j, blk in enumerate(bt[row].tolist()):
            lo = max(n_tok - j * bs, 0)
            if lo < bs:
                kp2[blk, lo:] = 1e4
                vp2[blk, lo:] = -1e4
    assert torch.equal(got, ops.paged_attention(q, kp2, vp2, bt, lens))


@pytest.mark.gpu
def test_paged_kernel_describe(cuda_device):
    from repro_torch.kernels import paged_attention as pa
    for h, hkv, d, kernel in ((36, 36, 64, "paged_simt"),
                              (56, 8, 128, "paged_mma"),
                              (56, 8, 80, "paged_simt")):
        q, kp, _, bt, _ = _paged_rows(16, h, hkv, d, 16, 2400, LONG_LENGTHS,
                                      torch.bfloat16, cuda_device)
        info = pa.describe(q, kp, bt)
        assert info["kernel"] == kernel
        assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1
        assert info["n_split"] > 1


@pytest.mark.gpu
def test_paged_kernel_empty_block_table(cuda_device):
    """A table of no columns gives zeros without a launch, as the CPU
    route gives zeros."""
    q, kp, vp, _, _ = _case(2, 4, 2, 16, 8, 10, 3, torch.bfloat16,
                            cuda_device)
    bt = torch.zeros((2, 0), dtype=torch.int32, device=cuda_device)
    lengths = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    got = ops.paged_attention(q, kp, vp, bt, lengths)
    assert ops.launch_counts()["paged_attention"] == 0
    assert torch.equal(got, torch.zeros_like(q))


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take(cuda_device):
    q, kp, vp, bt, lengths = _case(2, 4, 2, 16, 8, 10, 3, torch.float32,
                                   cuda_device)
    with pytest.raises(TypeError):
        ops.paged_attention(q.half(), kp.half(), vp.half(), bt, lengths)
    with pytest.raises(TypeError):
        ops.paged_attention(q, kp, vp, bt.long(), lengths)
    with pytest.raises(ValueError):
        ops.paged_attention(q[:, :, :12].contiguous(), kp[..., :12]
                            .contiguous(), vp[..., :12].contiguous(), bt,
                            lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["minicpm-2b", "mistral-nemo-12b"])
def test_decode_through_kernel_matches_plain_path(cuda_device, arch):
    """Reduced model, float32: a chunked prefill, then one decode step
    through the kernel and through the plain gathered attention on the
    same pages."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_params(cfg, seed=0, device=cuda_device)
    pages = init_pages(cfg, 10, 8, cuda_device)
    bt = torch.tensor([[1, 2, 3, 4, 5, 6]], dtype=torch.int32,
                      device=cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (1, 12), device=cuda_device)
    _, pages = forward_paged(params, cfg, pages, {"tokens": toks}, bt,
                             torch.zeros(1, dtype=torch.int32,
                                         device=cuda_device))
    nxt = {"tokens": toks[:, -1:]}
    ctx = torch.tensor([12], dtype=torch.int32, device=cuda_device)
    ops.reset_launch_counts()
    out = {}
    for use_kernel in (True, False):
        copy = {k: v.clone() for k, v in pages.items()}
        out[use_kernel], _ = decode_step_paged(params, cfg, copy, nxt, bt,
                                               ctx, use_kernel=use_kernel)
    assert ops.launch_counts()["paged_attention"] == cfg.num_layers
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=2e-4)


# --------------------------- selective scan ---------------------------- #
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


def _scan_case(b, s, d, n, dtype, device, seed=3):
    """dt = softplus(normal), x, b, c, h0 normal, a = -exp(0.5 normal):
    the distribution of the reference's kernel tests."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    dt = torch.nn.functional.softplus(f(b, s, d))
    a = -torch.exp(0.5 * f(d, n))
    ins = [dt, f(b, s, d), f(b, s, n), f(b, s, n)]
    return ([t.to(dtype).to(device) for t in ins]
            + [a.to(device), f(b, d, n).to(device)])


SCAN_SHAPES = [
    (1, 32, 16, 8),
    (2, 64, 32, 8),
    (2, 128, 64, 16),
    (1, 64, 48, 16),          # D not a multiple of a block's channels
    (2, 100, 48, 16),         # S not a multiple of the chunk
    (2, 300, 96, 4),
    (1, 1, 8, 1),
    (2, 1024, 512, 16),       # falcon-mamba's state size, long sequence
    # the redesign's boundaries: 32-step chunks, 8-step sub-chunks, 32
    # (forward) and 128 (backward) channels a block, 16-byte copies
    (2, 77, 200, 1),          # every N; S, D ragged against all of them
    (1, 70, 128, 1),          # a partial 16-byte copy of B and C
    (2, 45, 136, 2),
    (1, 130, 264, 4),
    (2, 95, 72, 8),
    (2, 65, 136, 16),
    (2, 50, 45, 16),          # rows of 45 elements: element copies
    (1, 33, 130, 8),          # float32 rows not 16-byte multiples
    (2, 1024, 8192, 16),      # falcon-mamba-7b's training width
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernels_forward_match_plain(cuda_device, dtype, b, s, d, n):
    from repro_torch.kernels import selective_scan as ss
    from repro_torch.kernels.ref import selective_scan_ref
    args = _scan_case(b, s, d, n, dtype, cuda_device)
    ops.reset_launch_counts()
    y5, h5 = ops.selective_scan(*args)
    y6, h6, hck = ss.selective_scan_fwd_ckpt(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["selective_scan"] == 1
    assert ops.launch_counts()["selective_scan_fwd_ckpt"] == 1
    y_r, h_r = selective_scan_ref(*args)
    tol = SCAN_TOL[dtype]
    for y, h in ((y5, h5), (y6, h6)):
        assert y.dtype == dtype and h.dtype == torch.float32
        torch.testing.assert_close(y.float(), y_r.float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(h, h_r, rtol=tol, atol=tol)
    # the checkpoint of chunk k is the state after k * chunk steps
    chunk = ss._library().selective_scan_chunk()
    assert hck.shape == (b, -(-s // chunk), d, n)
    assert torch.equal(hck[:, 0], args[5])
    if s > chunk:
        _, h_1 = selective_scan_ref(*[t[:, :chunk] for t in args[:4]],
                                    *args[4:])
        torch.testing.assert_close(hck[:, 1], h_1, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,d,n", SCAN_SHAPES)
def test_scan_backward_kernel_matches_autograd_of_plain(cuda_device, b, s,
                                                        d, n):
    """Every input gradient through the trainable kernel pair against
    autograd of the plain recurrence: max-abs error over the reference's
    max-abs below 1e-4 (the reference's own bound)."""
    from repro_torch.kernels.ref import selective_scan_ref
    args = _scan_case(b, s, d, n, torch.float32, cuda_device, seed=11)
    w = torch.randn(b, s, d, device=cuda_device)
    grads = {}
    ops.reset_launch_counts()
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in args]
        if route == "kernel":
            y, hf = ops.selective_scan(*leaves, trainable=True)
        else:
            y, hf = selective_scan_ref(*leaves)
        loss = (y * w).sum() + 0.5 * hf.sum()
        grads[route] = torch.autograd.grad(loss, leaves)
    counts = ops.launch_counts()
    assert counts["selective_scan_fwd_ckpt"] == 1
    assert counts["selective_scan_bwd"] == 1
    for name, k, r in zip(("dt", "x", "b", "c", "a", "h0"),
                          grads["kernel"], grads["plain"]):
        assert k.shape == r.shape and k.dtype == torch.float32
        err = float((k - r).abs().max() / (r.abs().max() + 1e-9))
        assert err < 1e-4, (name, err)


@pytest.mark.gpu
def test_scan_backward_is_deterministic(cuda_device):
    from repro_torch.kernels import selective_scan as ss
    args = _scan_case(2, 200, 96, 16, torch.float32, cuda_device)
    _, _, hck = ss.selective_scan_fwd_ckpt(*args)
    dy = torch.randn(2, 200, 96, device=cuda_device)
    dhf = torch.randn(2, 96, 16, device=cuda_device)
    first = ss.selective_scan_bwd(*args[:5], hck, dy, dhf)
    again = ss.selective_scan_bwd(*args[:5], hck, dy, dhf)
    for a_, b_ in zip(first, again):
        assert torch.equal(a_, b_)


@pytest.mark.gpu
def test_scan_wrappers_refuse_what_they_do_not_take(cuda_device):
    from repro_torch.kernels import selective_scan as ss
    args = _scan_case(1, 16, 8, 8, torch.float32, cuda_device)
    half = [t.half() for t in args[:4]] + args[4:]
    with pytest.raises(TypeError):
        ss.selective_scan(*half)
    bf = [t.bfloat16() for t in args[:4]] + args[4:]
    with pytest.raises(TypeError):
        ss.selective_scan_trainable(*bf)         # the backward is float32
    with pytest.raises(TypeError):
        ss.selective_scan(*args[:4], args[4].double(), args[5])
    wide = _scan_case(1, 16, 8, 32, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        ss.selective_scan(*wide)
    odd = _scan_case(1, 16, 8, 6, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        ss.selective_scan(*odd)
    with pytest.raises(ValueError):
        ss.selective_scan(args[0], args[1][:, :8].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        ss.selective_scan(args[0].transpose(1, 2).contiguous()
                          .transpose(1, 2), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        ss.selective_scan(*args[:5], args[5].cpu())
    _, _, hck = ss.selective_scan_fwd_ckpt(*args)
    with pytest.raises(ValueError, match="hck"):
        ss.selective_scan_bwd(*args[:5], hck[:, :0].contiguous(),
                              torch.zeros_like(args[1]), args[5])


@pytest.mark.gpu
def test_reduced_train_step_kernel_route_matches_plain(cuda_device):
    """One train step of reduced float32 falcon-mamba-7b through the scan
    kernels and through the chunked plain scan, from the same weights and
    batch: loss and gradient norm within 1e-4 relative, every parameter
    within 1e-5 (float32 throughout)."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").reduced(),
                              dtype="float32")
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             SyntheticLMDataset(DataConfig(cfg.vocab_size, 96, 4))
             .batch(0).items()}
    out = {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=0,
                                             device=cuda_device))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=2),
                               use_kernel=use_kernel)
        ops.reset_launch_counts()
        state, metrics = step(state, batch)
        counts = ops.launch_counts()
        out[use_kernel] = (metrics, tree_leaves(state.params))
        if use_kernel:
            assert counts["selective_scan_fwd_ckpt"] == 2 * cfg.num_layers
            assert counts["selective_scan_bwd"] == cfg.num_layers
        else:
            assert not any(counts.values())
    (mk, pk), (mp, pp) = out[True], out[False]
    for key in ("loss", "grad_norm"):
        assert float(mk[key]) == pytest.approx(float(mp[key]), rel=1e-4)
    for a_, b_ in zip(pk, pp):
        torch.testing.assert_close(a_, b_, rtol=0, atol=1e-5)


# ----------------------- multi_add, matmul_tiled ----------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(8, 1 << 20), (2, 1000003), (32, 4096),
                                 (17, 1000), (1, 5), (3, 8)])
def test_multi_add_kernel_matches_plain(cuda_device, dtype, k, n):
    """The kernel adds rows 0..K-1 in order in float32, as the plain
    version does: bitwise equal in both types (the same float32 sum,
    rounded once)."""
    from repro_torch.kernels.ref import multi_add_ref
    gen = torch.Generator(device=cuda_device).manual_seed(k * 7 + n)
    x = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    ops.reset_launch_counts()
    got = ops.multi_add(x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["multi_add"] == 1
    assert got.dtype == dtype and got.shape == (n,)
    assert torch.equal(got, multi_add_ref(x))


@pytest.mark.gpu
def test_multi_add_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 64), device=cuda_device)
    with pytest.raises(TypeError):
        ops.multi_add(x.half())
    with pytest.raises(ValueError):
        ops.multi_add(x[:, ::2])
    with pytest.raises(ValueError):
        ops.multi_add(x[0])


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-30))


#: float32: another order of the adds over K; bfloat16: the float32 sums
#: round to bf16 on either side of a boundary, one bf16 ulp (<= 2^-7 of
#: the value) apart
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1024, 2560, 7168), (130, 70, 260),
                                   (1, 8, 3), (33, 17, 129), (256, 96, 200),
                                   (128, 0, 64)])
def test_matmul_tiled_kernel_matches_plain(cuda_device, dtype, m, k, n):
    from repro_torch.kernels.ref import matmul_tiled_ref
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    ops.reset_launch_counts()
    got = ops.matmul_tiled(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul_tiled"] == 1
    want = matmul_tiled_ref(x, w)
    assert got.dtype == dtype and got.shape == (m, n)
    if k == 0:
        assert torch.all(got == 0)
    else:
        assert _rel_err(got, want) <= MM_TOL[dtype]


@pytest.mark.gpu
def test_matmul_tiled_unaligned_bf16_takes_the_masked_loads(cuda_device):
    """K not a multiple of 8 (rows not 16-byte aligned): the element-wise
    load path, same result as the aligned path on the same values."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((100, 37), generator=gen,
                    device=cuda_device).bfloat16()
    w = torch.randn((37, 136), generator=gen,
                    device=cuda_device).bfloat16()
    xp = torch.zeros((100, 40), device=cuda_device, dtype=torch.bfloat16)
    wp = torch.zeros((40, 136), device=cuda_device, dtype=torch.bfloat16)
    xp[:, :37], wp[:37] = x, w
    assert torch.equal(ops.matmul_tiled(x, w), ops.matmul_tiled(xp, wp))


def _variant_counts(name):
    return ops.variant_launch_counts()[name]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [
    (1024, 2560, 7168),     # one ring step of the yi-34b TP-8 fused ring
    (1000, 2552, 7000),     # ragged M and N, a K tail of 56 (not 64)
    (1000, 2560, 7000),
    (100, 512, 1024),       # M < 128: fewer tiles than SMs
    (8, 8, 8),
    (128, 0, 64),           # K == 0: zeros
])
def test_matmul_wgmma_variant_matches_plain(cuda_device, m, k, n):
    """The TMA + wgmma variant against the plain version (MM_TOL in
    bfloat16); one launch, of that variant."""
    from repro_torch.kernels.matmul_tiled import matmul_tiled_cuda
    from repro_torch.kernels.ref import matmul_tiled_ref
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((k, n), generator=gen, device=cuda_device).bfloat16()
    ops.reset_launch_counts()
    got = matmul_tiled_cuda(x, w)
    torch.cuda.synchronize()
    assert _variant_counts("matmul_tiled") == {"wgmma": 1, "wmma_masked": 0,
                                               "simt_f32": 0}
    assert ops.launch_counts()["matmul_tiled"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    if k == 0:
        assert torch.all(got == 0)
    else:
        assert _rel_err(got, matmul_tiled_ref(x, w)) <= MM_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_matmul_variants_forced_and_refused(cuda_device):
    """The WMMA kernel forced on an aligned call (the yardstick
    chip_smoke.py times) agrees with the plain version; forcing the wgmma
    variant on unaligned rows or float32 raises."""
    from repro_torch.kernels.matmul_tiled import matmul_tiled_cuda
    from repro_torch.kernels.ref import matmul_tiled_ref
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((300, 264), generator=gen, device=cuda_device).bfloat16()
    w = torch.randn((264, 520), generator=gen, device=cuda_device).bfloat16()
    ops.reset_launch_counts()
    got = matmul_tiled_cuda(x, w, variant="wmma_masked")
    torch.cuda.synchronize()
    assert _variant_counts("matmul_tiled")["wmma_masked"] == 1
    assert _rel_err(got, matmul_tiled_ref(x, w)) <= MM_TOL[torch.bfloat16]
    with pytest.raises(ValueError):
        matmul_tiled_cuda(x[:, :261].contiguous(), w[:261].contiguous(),
                          variant="wgmma")
    with pytest.raises(ValueError):
        matmul_tiled_cuda(x.float(), w.float(), variant="wgmma")
    assert ops.launch_counts()["matmul_tiled"] == 1


@pytest.mark.gpu
def test_matmul_tiled_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((8, 16), device=cuda_device)
    w = torch.zeros((16, 4), device=cuda_device)
    with pytest.raises(TypeError):
        ops.matmul_tiled(x, w.bfloat16())
    with pytest.raises(TypeError):
        ops.matmul_tiled(x.half(), w.half())
    with pytest.raises(ValueError):
        ops.matmul_tiled(x, w[:8])
    with pytest.raises(ValueError):
        ops.matmul_tiled(x.t(), torch.zeros((8, 4), device=cuda_device))
    with pytest.raises(ValueError):
        ops.matmul_tiled(x, w.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_tiled_backward_is_the_dense_float32_one(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((96, 80), generator=gen, device=cuda_device).to(dtype)
    w = torch.randn((80, 72), generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((96, 72), generator=gen, device=cuda_device).to(dtype)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    ops.matmul_tiled(xl, wl).backward(g)
    dx = torch.matmul(g.float(), w.float().t()).to(dtype)
    dw = torch.matmul(x.float().t(), g.float()).to(dtype)
    assert torch.equal(xl.grad, dx) and torch.equal(wl.grad, dw)


# ---------------------- collectives on local ranks --------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ring_on_8_local_ranks(cuda_device, dtype):
    """8 LocalComm ranks on one card: 64 block GEMMs through the kernel;
    each rank's block against the gathered path.  Tolerance: float32 as
    the kernel's; bfloat16 rounds at each of the 8 hops on both paths
    (at most 16 roundings of 2^-8 of the largest partial)."""
    from repro_torch.collectives import CollectiveEngine, run_local
    from repro_torch.collectives import shardmap_impl as impl
    p, m, k, n = 8, 256, 96, 136
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn((p, m, k), generator=gen, device=cuda_device).to(dtype)
    w = (torch.randn((p, k, n), generator=gen, device=cuda_device)
         / (p * k) ** 0.5).to(dtype)
    eng = CollectiveEngine(persist=False)
    ops.reset_launch_counts()
    got = run_local(lambda c: eng.fused_matmul_reduce_scatter(
        x[c.rank], w[c.rank], c, algorithm="fused"), p)
    torch.cuda.synchronize()
    assert ops.launch_counts()["matmul_tiled"] == p * p
    want = run_local(lambda c: impl.matmul_then_rs(x[c.rank], w[c.rank], c),
                     p)
    tol = 1e-5 if dtype == torch.float32 else 16 * 2.0 ** -8
    for r in range(p):
        assert got[r].shape == (m // p, n) and got[r].dtype == dtype
        assert _rel_err(got[r], want[r]) <= tol, r


@pytest.mark.gpu
def test_every_collective_exact_on_8_local_ranks(cuda_device):
    """Integer-valued float32 inputs: every op x algorithm on 8 local
    ranks on the card is exact."""
    from repro_torch.collectives import CollectiveEngine, run_local
    algorithms = {
        "reduce": ["chain", "tree", "two_phase", "star", "autogen",
                   "autogen_pipelined", "auto"],
        "allreduce": ["psum", "oneshot", "ring", "two_phase", "autogen",
                      "auto"],
        "reduce_scatter": ["psum_scatter", "ring", "autogen", "auto"],
        "allgather": ["all_gather", "ring", "doubling", "autogen", "auto"],
        "broadcast": ["doubling", "chain", "autogen", "auto"],
        "all_to_all": ["lax", "ring", "halving", "auto"]}
    p = 8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    xs = [torch.randint(-8, 9, (128, 33), generator=gen,
                        device=cuda_device).float() for _ in range(p)]
    total = torch.stack(xs).sum(0)
    eng = CollectiveEngine(persist=False)
    for op, algs in algorithms.items():
        fn = getattr(eng, op + "_inside")
        for alg in algs:
            if op == "broadcast":
                out = run_local(lambda c: fn(xs[c.rank], c, 5, alg), p)
                want = [xs[5]] * p
            else:
                out = run_local(lambda c: fn(xs[c.rank], c, alg), p)
                want = {
                    "reduce": [total] + [None] * (p - 1),
                    "allreduce": [total] * p,
                    "reduce_scatter": list(total.chunk(p)),
                    "allgather": [torch.cat(xs)] * p,
                    "all_to_all": [torch.cat([x.chunk(p)[r] for x in xs])
                                   for r in range(p)]}[op]
            for r in range(p):
                if want[r] is not None:
                    assert torch.equal(out[r], want[r]), (op, alg, r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alg", ["2d_snake", "2d_xy"])
def test_2d_allreduce_on_a_2x4_grid_bitwise_equal_to_cpu_ranks(
        cuda_device, alg, dtype):
    """The paper's 2D AllReduces on 8 local ranks of the card as a
    (pod 2, data 4) grid, on normal values of odd length: bitwise equal
    to the same plan on CPU ranks (every add is one rounding of two
    values of the input type, in the same order)."""
    from repro_torch.collectives import CollectiveEngine, run_local_grid
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn((4097,), generator=gen).to(dtype) for _ in range(8)]
    out = {}
    for dev in ("cpu", cuda_device):
        eng = CollectiveEngine(persist=False, device=dev)
        local = [x.to(dev) for x in xs]
        out[str(dev)] = run_local_grid(lambda g: eng.allreduce_multi(
            local[g.rank], g, ("pod", "data"), alg), (2, 4),
            ("pod", "data"), dev)
    for r in range(8):
        got = out[str(cuda_device)][r].cpu()
        assert got.dtype == dtype and got.shape == (4097,)
        assert torch.equal(got, out["cpu"][r]), (alg, r)


_NCCL_SCRIPT = r"""
import sys
import torch, torch.distributed as dist
from repro_torch.collectives import CollectiveEngine, ProcessGroupComm
from repro_torch.collectives import shardmap_impl as impl
rank, world, init, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
dist.init_process_group("nccl", init_method=init, rank=rank,
                        world_size=world)
comm = ProcessGroupComm(device=f"cuda:{rank}")
eng = CollectiveEngine(persist=False, device=comm.device)
gen = torch.Generator().manual_seed(rank)
x = torch.randint(-8, 9, (64, 5), generator=gen).float().to(comm.device)
res = {f"{op}/{alg}": getattr(eng, op + "_inside")(x, comm, alg).cpu()
       for op, alg in [("reduce", "chain"), ("allreduce", "ring"),
                       ("allreduce", "psum"), ("reduce_scatter", "autogen"),
                       ("allgather", "doubling"), ("all_to_all", "halving"),
                       ("all_to_all", "lax")]}
res["x"] = x.cpu()
res["fused"] = impl.fused_matmul_rs(x[:, :4].contiguous(),
                                  x[:4, :3].contiguous(), comm).cpu()
torch.save(res, out)
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_process_group_comm_over_nccl(cuda_device, tmp_path):
    """One ProcessGroupComm rank per card (at most 4), against the same
    ops on LocalComm ranks: exact on integer-valued inputs."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    from repro_torch.collectives import CollectiveEngine, run_local
    from repro_torch.collectives import shardmap_impl as impl
    world = min(torch.cuda.device_count(), 4)
    if world < 2:
        pytest.skip("NCCL needs two cards: it refuses two ranks on one")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_SCRIPT, str(r),
                               str(world), init, str(tmp_path / f"{r}.pt")],
                              env=env, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-4000:]
    res = [torch.load(tmp_path / f"{r}.pt") for r in range(world)]
    xs = [r["x"].to(cuda_device) for r in res]
    eng = CollectiveEngine(persist=False)
    for key in res[0]:
        if key in ("x", "fused"):
            continue
        op, alg = key.split("/")
        local = run_local(lambda c: getattr(eng, op + "_inside")(
            xs[c.rank], c, alg), world)
        for r in range(world):
            if op == "reduce" and r:
                continue
            assert torch.equal(res[r][key], local[r].cpu()), (key, r)
    local = run_local(lambda c: impl.fused_matmul_rs(
        xs[c.rank][:, :4].contiguous(), xs[c.rank][:4, :3].contiguous(), c),
        world)
    for r in range(world):
        assert torch.equal(res[r]["fused"], local[r].cpu())


# ---------------------------- flash attention --------------------------- #
def _flash_inputs(b, h, hkv, s, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype).to(device)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


FLASH_SHAPES = [
    # (b, h, hkv, s, d, causal, window)
    (2, 4, 4, 256, 64, True, None),
    (1, 8, 2, 512, 128, True, None),      # GQA, head dim 128
    (1, 4, 1, 256, 32, False, None),      # MQA, not causal
    (2, 4, 2, 384, 64, True, 100),        # sliding window
    (1, 4, 4, 320, 64, False, 64),        # window without the causal mask
    (1, 2, 2, 128, 128, False, 0),        # the last row keeps no key
    (1, 36, 36, 1024, 64, True, None),    # minicpm-2b heads
    (2, 4, 2, 256, 16, True, None),       # the reduced configs' head dim
    (1, 4, 4, 512, 96, True, None),       # phi3-mini-3.8b's head dim, MHA
    (1, 4, 1, 384, 160, True, None),      # mistral-nemo-12b's, GQA 4/1
    (1, 4, 1, 256, 160, False, 100),      # D 160, window, not causal
    (1, 4, 1, 384, 256, True, 128),       # recurrentgemma-9b's local
    (2, 2, 2, 256, 256, True, None),      # D 256, MHA, causal
    (2, 4, 4, 512, 64, False, None),      # non-causal, no window (wgmma)
    (1, 16, 16, 1024, 64, False, None),   # whisper-medium's heads
    (1, 14, 2, 512, 128, True, None),     # yi-34b's heads a rank at TP-4
    (1, 4, 4, 512, 128, True, None),      # olmoe-1b-7b's at TP-4
    (1, 4, 1, 384, 256, True, 128),       # recurrentgemma-9b's at TP-4
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda_device, dtype, b, h, hkv, s, d,
                                    causal, window):
    """Output against the plain version's float32 output: float32 within
    2e-5, bf16 element by element within one bf16 ulp plus 1e-5 (the
    bound of chip_smoke.py's bf16 check); lse within 1e-4 (float32 sums
    in another order); a row with no key gives zeros and lse -inf,
    exactly as the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_inputs(b, h, hkv, s, d, dtype, cuda_device)
    ops.reset_launch_counts()
    o, lse = flash_attention_cuda(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    o_ref, lse_ref = flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal, window)
    assert o.dtype == dtype and o.shape == q.shape
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    live = torch.isfinite(lse_ref)
    assert torch.all(o[~live] == 0)
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=1e-4,
                               atol=1e-4)
    if dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(
            o_ref.abs().clamp_min(2.0 ** -126))) - 7)
        excess = (o.float() - o_ref).abs() - (ulp + 1e-5)
        assert float(excess.max()) <= 0.0, float(excess.max())
    else:
        torch.testing.assert_close(o, o_ref, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_strided_bshd_views(cuda_device, dtype):
    """q, k, v seen as [B, H, S, D] views of [B, S, H, D] tensors (what
    layers.attention passes): the same result as contiguous inputs, and
    the output has q's strides, so that it is [B, S, H, D] back again."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(2, 8, 4, 256, 64, dtype, cuda_device, seed=3)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    o, lse = flash_attention_cuda(*views)
    o2, lse2 = flash_attention_cuda(q, k, v)
    assert o.stride() == views[0].stride()
    assert o.transpose(1, 2).is_contiguous()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,hkv", [(96, 8, 8), (160, 8, 2)])
def test_flash_kernel_takes_strided_bshd_views_at_96_and_160(
        cuda_device, dtype, d, h, hkv):
    """The head dims of phi3-mini-3.8b (96) and mistral-nemo-12b (160)
    on [B, H, S, D] views of [B, S, H, D] tensors: the same result as
    contiguous inputs, in q's strides, through the mma_sync (bf16) or
    simt_f32 (float32) variant."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_variant)
    q, k, v = _flash_inputs(2, h, hkv, 256, d, dtype, cuda_device, seed=d)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    ops.reset_launch_counts()
    o, lse = flash_attention_cuda(*views)
    o2, lse2 = flash_attention_cuda(q, k, v)
    variant = flash_variant(dtype, d)
    assert variant in ("mma_sync", "simt_f32")
    assert ops.variant_launch_counts()["flash_attention"][variant] == 2
    assert o.stride() == views[0].stride()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _flash_close(o, lse, o_ref, lse_ref):
    """The bf16 checks of test_flash_kernel_matches_plain."""
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    live = torch.isfinite(lse_ref)
    torch.testing.assert_close(lse[live], lse_ref[live], rtol=1e-4,
                               atol=1e-4)
    ulp = torch.exp2(torch.floor(torch.log2(
        o_ref.abs().clamp_min(2.0 ** -126))) - 7)
    excess = (o.float() - o_ref).abs() - (ulp + 1e-5)
    assert float(excess.max()) <= 0.0, float(excess.max())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,h,hkv,s,causal,window", [
    (1, 4, 4, 4096, True, None),
    (1, 4, 4, 4096, False, None),
    (1, 4, 4, 4096, True, 2048),     # the local-attention window
    (1, 32, 8, 512, True, None),     # GQA 32/8
    (2, 4, 2, 320, True, None),      # S a multiple of 64, not of 128
    (1, 4, 4, 320, False, 100),
])
def test_flash_wgmma_variant_matches_plain(cuda_device, d, b, h, hkv, s,
                                           causal, window):
    """The TMA + wgmma variant (bf16, D 64 and 128) against the plain
    version's float32 output, element by element within one bf16 ulp plus
    1e-5, lse within 1e-4; one launch, of that variant."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_inputs(b, h, hkv, s, d, torch.bfloat16, cuda_device,
                            seed=s + d)
    ops.reset_launch_counts()
    o, lse = flash_attention_cuda(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert ops.variant_launch_counts()["flash_attention"] == {
        "wgmma": 1, "mma_sync": 0, "simt_f32": 0}
    o_ref, lse_ref = flash_attention_ref(q.float(), k.float(), v.float(),
                                         causal, window)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    _flash_close(o, lse, o_ref, lse_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_variant_takes_strided_bshd_views(cuda_device, d):
    """[B, H, S, D] views of [B, S, H, D] tensors through the rank-4
    tensor maps: the same result as contiguous inputs, in q's strides."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    q, k, v = _flash_inputs(2, 8, 4, 384, d, torch.bfloat16, cuda_device,
                            seed=9)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    ops.reset_launch_counts()
    o, lse = flash_attention_cuda(*views)
    o2, lse2 = flash_attention_cuda(q, k, v)
    assert ops.variant_launch_counts()["flash_attention"]["wgmma"] == 2
    assert o.stride() == views[0].stride()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.gpu
def test_flash_variants_forced_and_refused(cuda_device):
    """The mma.sync kernel forced at D 64 (the yardstick chip_smoke.py
    times) passes the same checks; the wgmma variant forced at D 32 or on
    float32 inputs raises."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    q, k, v = _flash_inputs(1, 4, 2, 512, 64, torch.bfloat16, cuda_device)
    ops.reset_launch_counts()
    o, lse = flash_attention_cuda(q, k, v, variant="mma_sync")
    torch.cuda.synchronize()
    assert ops.variant_launch_counts()["flash_attention"]["mma_sync"] == 1
    _flash_close(o, lse, *flash_attention_ref(q.float(), k.float(),
                                              v.float(), True, None))
    small = _flash_inputs(1, 4, 2, 128, 32, torch.bfloat16, cuda_device)
    with pytest.raises(ValueError):
        flash_attention_cuda(*small, variant="wgmma")
    with pytest.raises(ValueError):
        flash_attention_cuda(*[t.float() for t in (q, k, v)],
                             variant="wgmma")


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    dev = cuda_device
    ok = _flash_inputs(1, 4, 2, 128, 64, torch.bfloat16, dev)
    cases = [
        ("a CPU tensor", [t.cpu() for t in ok], ValueError),
        ("S not a multiple of 64",
         _flash_inputs(1, 4, 2, 100, 64, torch.bfloat16, dev), ValueError),
        ("head dim 48", _flash_inputs(1, 4, 2, 128, 48, torch.float32, dev),
         ValueError),
        ("head dim 80",
         _flash_inputs(1, 4, 2, 128, 80, torch.bfloat16, dev), ValueError),
        ("head dim 192",
         _flash_inputs(1, 2, 1, 128, 192, torch.bfloat16, dev), ValueError),
        ("H not a multiple of Hkv",
         _flash_inputs(1, 3, 2, 128, 64, torch.float32, dev), ValueError),
        ("float16", [t.half() for t in ok], TypeError),
        ("mixed dtypes", [ok[0], ok[1].float(), ok[2]], TypeError),
        ("a strided last dimension",
         [ok[0][..., ::2], ok[1][..., ::2], ok[2][..., ::2]], ValueError),
        ("rows not 16-byte aligned",
         [torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
          .view(t.shape) for t in ok], ValueError),
    ]
    for label, (q, k, v), exc in cases:
        with pytest.raises(exc):
            flash_attention_cuda(q, k, v)
            pytest.fail(label)


@pytest.mark.gpu
@pytest.mark.parametrize("causal,window,hkv", [(True, None, 2),
                                               (False, 96, 1),
                                               (True, 80, 4)])
def test_flash_fn_gradient_matches_autograd_of_plain(cuda_device, causal,
                                                     window, hkv):
    """FlashAttentionFn (kernel forward, plain flash backward) against
    autograd through the plain version, float32: each gradient within
    1e-4 of the plain gradient's max-abs."""
    from repro_torch.kernels.ref import flash_attention_ref
    ins = _flash_inputs(2, 4, hkv, 256, 64, torch.float32, cuda_device, 5)
    do = torch.randn(ins[0].shape, device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(1))
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = (ops.flash_attention(*leaves, causal=causal, window=window)
               if route == "kernel"
               else flash_attention_ref(*leaves, causal, window)[0])
        grads[route] = torch.autograd.grad(out, leaves, do)
    for g, r in zip(grads["kernel"], grads["plain"]):
        assert float((g - r).abs().max() / r.abs().max()) < 1e-4


@pytest.mark.gpu
def test_attention_chunked_branch_launches_the_kernel(cuda_device):
    """layers.attention at S 4096 on a CUDA tensor: one kernel launch,
    the same result as the plain chunked route (use_kernel=False, no
    launch), and probs_bf16 refused on the kernel route."""
    from repro_torch.models.layers import attention
    q, k, v = [t.transpose(1, 2).contiguous() for t in _flash_inputs(
        1, 4, 2, 4096, 64, torch.float32, cuda_device, seed=7)]
    ops.reset_launch_counts()
    got = attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1
    plain = attention(q, k, v, use_kernel=False)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got, plain, rtol=2e-5, atol=2e-5)
    with pytest.raises(NotImplementedError, match="probs_bf16"):
        attention(q, k, v, probs_bf16=True)


@pytest.mark.gpu
def test_reduced_dense_train_step_kernel_route_matches_plain(cuda_device):
    """One train step of reduced float32 minicpm-2b at S 4096 through the
    flash kernel and through the plain chunked attention: two launches a
    layer (forward and the remat recompute), loss and gradient norm
    within 1e-4 relative, every parameter within 1e-5."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              dtype="float32")
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             SyntheticLMDataset(DataConfig(cfg.vocab_size, 4096, 2))
             .batch(0).items()}
    out = {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=0,
                                             device=cuda_device))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=2,
                                                schedule="wsd"),
                               use_kernel=use_kernel)
        ops.reset_launch_counts()
        state, metrics = step(state, batch)
        counts = ops.launch_counts()
        out[use_kernel] = (metrics, tree_leaves(state.params))
        want = dict.fromkeys(ops.WRAPPERS, 0)
        if use_kernel:
            want["flash_attention"] = 2 * cfg.num_layers
        assert counts == want
    (mk, pk), (mp, pp) = out[True], out[False]
    for key in ("loss", "grad_norm"):
        assert float(mk[key]) == pytest.approx(float(mp[key]), rel=1e-4)
    for a_, b_ in zip(pk, pp):
        torch.testing.assert_close(a_, b_, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_dense_step_attention_backward_ranges_on_the_card(cuda_device):
    """Reduced minicpm-2b (2 layers, bf16, 2 x 4096) through the flash
    kernel, one step under ``torch.profiler`` after a warm-up step: one
    ``repro_torch.train.step``, ``train.forward``, ``train.backward`` and
    ``optim.update``, and a ``repro_torch.attn.backward`` range a layer,
    each with the device time of the kernels launched inside it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    cfg = get_config("minicpm-2b").reduced()
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             SyntheticLMDataset(DataConfig(cfg.vocab_size, 4096, 2))
             .batch(0).items()}
    state = init_train_state(init_params(cfg, seed=0, device=cuda_device))
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=4))
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 2 * cfg.num_layers
    assert torch.isfinite(metrics["loss"])
    ranges = {}
    for e in prof.events():
        if e.name.startswith("repro_torch.") and \
                e.device_type == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name, []).append(e)
    assert {n: len(v) for n, v in ranges.items()} == {
        "repro_torch.train.step": 1, "repro_torch.train.forward": 1,
        "repro_torch.train.backward": 1, "repro_torch.optim.update": 1,
        "repro_torch.attn.backward": cfg.num_layers}
    for e in ranges["repro_torch.attn.backward"]:
        assert e.device_time_total > 0, e


def _reduced_hybrid():
    """Reduced recurrentgemma-9b in float32 with 5 layers (one rglru,
    rglru, local cycle and a 2-block RG-LRU tail) at the full config's
    head dim 256, so that its local layer reaches the D 256 kernel."""
    return dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                               dtype="float32", num_layers=5, head_dim=256)


@pytest.mark.gpu
def test_reduced_hybrid_train_step_kernel_route_matches_plain(cuda_device):
    """One train step of the reduced hybrid at S 4096 (window 32) through
    the flash kernel and through the plain chunked attention: two
    launches for the one local layer (forward and the cycle's remat
    recompute), all simt_f32; loss and gradient norm within 1e-4
    relative, every parameter within 1e-5."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves
    cfg = _reduced_hybrid()
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in
             SyntheticLMDataset(DataConfig(cfg.vocab_size, 4096, 1))
             .batch(0).items()}
    out = {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=0,
                                             device=cuda_device))
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=2),
                               use_kernel=use_kernel)
        ops.reset_launch_counts()
        state, metrics = step(state, batch)
        out[use_kernel] = (metrics, tree_leaves(state.params))
        want = dict.fromkeys(ops.WRAPPERS, 0)
        if use_kernel:
            want["flash_attention"] = 2
            assert ops.variant_launch_counts()["flash_attention"][
                "simt_f32"] == 2
        assert ops.launch_counts() == want
    (mk, pk), (mp, pp) = out[True], out[False]
    for key in ("loss", "grad_norm"):
        assert float(mk[key]) == pytest.approx(float(mp[key]), rel=1e-4)
    for a_, b_ in zip(pk, pp):
        torch.testing.assert_close(a_, b_, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_reduced_hybrid_prefill_and_decode_on_cuda(cuda_device):
    """Prefill of a 4096-token prompt launches the kernel once for the one
    local layer; 8 decode steps over the ring launch nothing; each step's
    logits follow the teacher-forced forward within 2e-4 (float32)."""
    from repro_torch.models import decode_step, forward_train, prefill
    cfg = _reduced_hybrid()
    params = init_params(cfg, seed=0, device=cuda_device)
    seq = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 5120)).astype(np.int32)).to(cuda_device)
    with torch.no_grad():
        ops.reset_launch_counts()
        last, cache = prefill(params, cfg, {"tokens": seq[:, :4096]})
        assert ops.launch_counts()["flash_attention"] == 1
        steps = [last]
        for t in range(4096, 4104):
            last, cache = decode_step(params, cfg, cache,
                                      {"tokens": seq[:, t:t + 1]})
            steps.append(last)
        assert ops.launch_counts()["flash_attention"] == 1
        full, _ = forward_train(params, cfg, {"tokens": seq})
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 4095:4104],
                               rtol=2e-4, atol=2e-4)


# ------------------ data and tensor parallelism (slice 9) ---------------- #
def _tiny_dense():
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                      dtype="float32")


def _dp_steps(device, mode, fused=False):
    """Two DP steps of the tiny dense config on a 2 x 2 grid of rank
    threads on ``device``; every rank's params."""
    from repro_torch.collectives import run_local_grid
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import GradSyncConfig, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = _tiny_dense()
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, 64, (8, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    base = init_params(cfg, seed=0, device="cpu")

    def fn(grid):
        # a copy a rank: the step updates its parameters in place
        params = {k: ([{n: t.to(grid.device, copy=True)
                        for n, t in lp.items()} for lp in v]
                      if k == "layers" else v.to(grid.device, copy=True))
                  for k, v in base.items()}
        gs = GradSyncConfig(grid=grid, axes=("pod", "data"), mode=mode,
                            fused=fused)
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1,
                                                total_steps=10),
                               grad_sync=gs)
        st = init_train_state(params)
        rows = {k: v[2 * grid.rank:2 * grid.rank + 2].to(grid.device)
                for k, v in batch.items()}
        for _ in range(2):
            st, m = step(st, rows)
        return float(m["loss"]), [p.cpu() for p in tree_leaves(st.params)]

    return run_local_grid(fn, (2, 2), ("pod", "data"), device, timeout=120)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,fused", [("allreduce", False),
                                        ("fsdp", False), ("fsdp", True)])
def test_dp_step_on_cuda_rank_threads_matches_cpu_ranks(cuda_device, mode,
                                                        fused):
    gpu = _dp_steps(cuda_device, mode, fused)
    cpu = _dp_steps("cpu", mode, fused)
    # float32 on both; cuBLAS and the CPU sum in other orders: the
    # reference test's bounds (tests/test_engine.py:431)
    for (lg, pg), (lc, pc) in zip(gpu, cpu):
        assert lg == pytest.approx(lc, rel=1e-5)
        for a_, b_ in zip(pg, pc):
            torch.testing.assert_close(a_, b_, rtol=1e-4, atol=1e-5)


def _fused_swiglu(device, monkeypatch=None):
    """``swiglu`` through the fused TP ring on a (2, 4) (data, model) grid
    of rank threads (the engine's price made to favour the ring): each
    rank's value and weight gradients."""
    from repro_torch.collectives import run_local_grid
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 16, 32)).astype(np.float32)
    ws = [(rng.normal(size=s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((32, 64), (32, 64), (64, 32))]

    def fn(grid):
        d = grid.axis_index("data")
        xr = torch.from_numpy(x[4 * d:4 * d + 4]).to(grid.device)
        w = [torch.from_numpy(a).to(grid.device).requires_grad_()
             for a in ws]
        with layers.ambient_grid(grid):
            y = layers.swiglu(xr, *w)
        loss = (y * y).sum()
        grads = torch.autograd.grad(loss, w)
        return float(loss.detach()), [g.cpu() for g in grads]

    layers.set_fused_tp(True)
    try:
        return run_local_grid(fn, (2, 4), ("data", "model"), device,
                              timeout=120)
    finally:
        layers.set_fused_tp(False)


@pytest.mark.gpu
def test_fused_tp_swiglu_on_cuda_matches_cpu_and_launches_p_per_rank(
        cuda_device, monkeypatch):
    from repro_torch.collectives import CollectiveEngine
    price = CollectiveEngine.price_fused_matmul_rs
    monkeypatch.setattr(CollectiveEngine, "price_fused_matmul_rs",
                        lambda self, *a, **k: dict(price(self, *a, **k),
                                                   saved=1.0))
    ops.reset_launch_counts()
    gpu = _fused_swiglu(cuda_device)
    counts = ops.launch_counts()
    cpu = _fused_swiglu("cpu")
    # one ring over the model axis of 4 per rank, P block GEMMs each
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["matmul_tiled"] = 8 * 4
    assert counts == want, counts
    for (lg, gg), (lc, gc) in zip(gpu, cpu):
        assert lg == pytest.approx(lc, rel=1e-5)
        for a_, b_ in zip(gg, gc):
            torch.testing.assert_close(a_, b_, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_autograd_runs_cuda_backward_nodes_on_one_device_thread(
        cuda_device):
    """Two threads call ``backward`` on CUDA graphs together: each graph's
    custom node runs on the autograd engine's worker thread for the
    device, one thread for both callers and neither caller.  A node that
    waited there for another rank's node would wait forever; so the
    fused TP down-projection's backward has no collective, and
    ``forward_train`` refuses remat with it on CUDA."""
    import threading
    seen = {}
    barrier = threading.Barrier(2, timeout=30)

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            seen.setdefault("backward", []).append(threading.get_ident())
            return g * 2

    def worker(i):
        seen[f"caller{i}"] = threading.get_ident()
        x = torch.ones(4, device=cuda_device, requires_grad=True)
        y = Probe.apply(x).sum()
        barrier.wait()
        y.backward()

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    nodes = seen["backward"]
    assert len(nodes) == 2 and nodes[0] == nodes[1]
    assert nodes[0] not in (seen["caller0"], seen["caller1"])


@pytest.mark.gpu
def test_remat_with_fused_tp_on_cuda_is_refused(cuda_device):
    from repro_torch.collectives import run_local_grid
    from repro_torch.models import forward_train, layers
    cfg = _tiny_dense()
    params = init_params(cfg, seed=0, device=cuda_device)
    tokens = torch.zeros((2, 8), dtype=torch.int32, device=cuda_device)

    def fn(grid, grad):
        # grad mode is per thread: set it in the rank's own thread
        with torch.set_grad_enabled(grad), layers.ambient_grid(grid):
            return forward_train(params, cfg, {"tokens": tokens})

    layers.set_fused_tp(True)
    try:
        with pytest.raises(NotImplementedError, match="remat"):
            run_local_grid(lambda g: fn(g, True), (2,), ("model",),
                           cuda_device, timeout=60)
        # no backward: the fused route runs
        out = run_local_grid(lambda g: fn(g, False), (2,), ("model",),
                             cuda_device, timeout=60)
    finally:
        layers.set_fused_tp(False)
    want, _ = forward_train(params, cfg, {"tokens": tokens}, remat=False)
    for logits, _ in out:
        torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-5)


# ------------------------------ the MoE FFN ------------------------------ #
def _moe_inputs(g, gs, d, e, f, dtype, device, seed=11):
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=1.0: torch.from_numpy(
        (rng.normal(size=shape) * s).astype(np.float32))
    x, router = t(g, gs, d), t(d, e, s=d ** -0.5)
    ws = [t(e, d, f, s=d ** -0.5), t(e, d, f, s=d ** -0.5),
          t(e, f, d, s=f ** -0.5)]
    return ([x.to(dtype).to(device), router.to(device)]
            + [w.to(dtype).to(device) for w in ws])


@pytest.mark.gpu
def test_moe_ffn_on_cuda_matches_the_cpu(cuda_device):
    """float32 at 1e-5, with a capacity that drops tokens (group 256,
    E 16, top 4, capacity factor 0.5: 32 slots an expert for 64 entries
    on average)."""
    from repro_torch.models import moe
    args = _moe_inputs(2, 256, 128, 16, 64, torch.float32, cuda_device)
    got, aux = moe.moe_ffn(*args, top_k=4, capacity_factor=0.5)
    want, want_aux = moe.moe_ffn(*(a.cpu() for a in args), top_k=4,
                                 capacity_factor=0.5)
    r = moe.Routing(args[0].cpu(), args[1].cpu(), 4, 0.5)
    assert int((~r.keep).sum()) > 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)


@pytest.mark.gpu
def test_moe_combine_is_bitwise_repeatable_on_cuda(cuda_device):
    """Two calls at olmoe-1b-7b's widths (E 64, top 8, D 2048, F 1024,
    bf16): no atomics in the dispatch or the combine."""
    from repro_torch.models import moe
    args = _moe_inputs(2, 128, 2048, 64, 1024, torch.bfloat16, cuda_device)
    a, aux_a = moe.moe_ffn(*args, top_k=8)
    b, aux_b = moe.moe_ffn(*args, top_k=8)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.gpu
def test_paged_kernel_at_olmoe_decode_shape(cuda_device):
    """olmoe-1b-7b's decode: 16 / 16 heads x 128, bf16, blocks of 16,
    serving-length rows (paged_simt)."""
    _check_paged(*_paged_rows(8, 16, 16, 128, 16, 240,
                              [97, 0, 130, 211, 16, 305, 64, 383],
                              torch.bfloat16, cuda_device))


@pytest.mark.gpu
def test_moe_ep_on_cuda_threads_is_forward_only(cuda_device):
    """EP on 4 CUDA rank threads: the forward equals moe_ffn; a backward
    through its exchanges is refused (ROADMAP C15)."""
    from repro_torch.collectives import CollectiveEngine, run_local_grid
    from repro_torch.models import layers, moe, moe_ep
    args = _moe_inputs(4, 32, 64, 8, 32, torch.float32, cuda_device)
    eng = CollectiveEngine(persist=False, device=cuda_device)
    want, _ = moe.moe_ffn(*args, top_k=2)

    def rank(grid, grad):
        with torch.set_grad_enabled(grad), layers.ambient_grid(grid):
            return moe_ep.moe_ffn_ep(args[0][grid.rank:grid.rank + 1],
                                     *args[1:], top_k=2, engine=eng)[0]

    outs = run_local_grid(lambda g: rank(g, False), (4,), ("data",),
                          cuda_device, timeout=60)
    torch.testing.assert_close(torch.cat(outs), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="C15"):
        run_local_grid(lambda g: rank(g, True), (4,), ("data",),
                       cuda_device, timeout=60)


# ------------------- calibration and observability ------------------- #
@pytest.mark.gpu
def test_measured_span_synchronises_on_cuda_threads(cuda_device):
    """A collective span with the tracer measuring synchronises the
    result's device before it closes: every rank's span has a wall
    time, and the stream is idle when ``finish_result`` returns."""
    from repro_torch.collectives import CollectiveEngine, run_local
    from repro_torch.obs import trace
    tr = trace.Tracer(enabled=True, measure=True)
    prev = trace.set_tracer(tr)
    try:
        eng = CollectiveEngine(persist=False, device="cuda")
        xs = [torch.full((1 << 20,), float(r), device="cuda")
              for r in range(4)]
        outs = run_local(lambda c: eng.allreduce_inside(xs[c.rank], c), 4,
                         "cuda", axis="data")
    finally:
        trace.set_tracer(prev)
    tops = [s for s in tr.spans if s.parent_id is None]
    assert sorted(s.args["rank"] for s in tops) == [0, 1, 2, 3]
    assert all(s.args["measured_s"] > 0 and s.args["mode"] == "eager"
               for s in tops)
    assert all(torch.equal(o, torch.full_like(o, 6.0)) for o in outs)
    assert trace.validate_spans(tr.spans) == []
    tr = trace.Tracer(enabled=True, measure=True)
    a = torch.randn(4096, 4096, device="cuda")
    with tr.span("matmul", cat=trace.CAT_PHASE) as sp:
        sp.finish_result(a @ a)
        assert torch.cuda.current_stream().query()
    assert tr.spans[0].args["measured_s"] > 0


@pytest.mark.gpu
def test_measure_ppermute_on_cuda_threads_is_positive_and_size_ordered(
        cuda_device):
    """On 4 rank threads of one card a shift is two barriers (~1 ms on
    an H100, PERF.md section 6) and 4 device copies: the copies order
    the times from a few hundred MB a rank on."""
    from repro_torch.collectives import run_local
    from repro_torch.collectives.engine import measure_ppermute
    sizes = (4096, 512 << 20, 2 << 30)
    out = run_local(lambda c: measure_ppermute(c, sizes, 5), 4, "cuda")
    assert all(m == out[0] for m in out)
    assert [nb for nb, _ in out[0]] == list(sizes)
    times = [t for _, t in out[0]]
    assert 0 < times[0] < times[1] < times[2], times


@pytest.mark.gpu
def test_calibrate_grid_on_cuda_threads_persists_and_restores(
        cuda_device, tmp_path, monkeypatch):
    """``calibrate(grid=)`` on a 2 x 2 grid of CUDA rank threads: a
    per-axis topology, persisted at the next flush; ``get_engine``
    restores it, and not under ``REPRO_TORCH_RESTORE_TOPOLOGY=0``.  The
    shifts go to 1 GB a rank so that the copies, not the barriers'
    jitter, set the slope."""
    from repro_torch.collectives import api, run_local_grid
    from repro_torch.collectives.engine import (CollectiveEngine,
                                                find_calibrated_topology)
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_TORCH_RESTORE_TOPOLOGY", raising=False)
    monkeypatch.setattr(api, "_ENGINES", {})
    eng = CollectiveEngine(device="cuda")
    topos = run_local_grid(
        lambda g: eng.calibrate(grid=g, sizes_bytes=(1 << 20, 64 << 20,
                                                     256 << 20, 1 << 30)),
        (2, 2), ("pod", "data"), "cuda")
    topo = topos[0]
    assert all(t == topo for t in topos) and eng.topology == topo
    assert topo.name == "tpu_v5e_axis_calibrated"
    assert [a for a, _ in topo.axis_fabrics] == ["data", "pod"]
    eng.select("allreduce", 4096, 8)
    eng.flush()
    assert find_calibrated_topology() == topo
    assert api.get_engine(device="cuda").topology == topo
    monkeypatch.setenv("REPRO_TORCH_RESTORE_TOPOLOGY", "0")
    monkeypatch.setattr(api, "_ENGINES", {})
    assert find_calibrated_topology() is None
    assert api.get_engine(device="cuda").topology.is_uniform


# ------- vision soft tokens and the encoder-decoder (slice 13) ------- #
def _reduced_encdec(dtype="float32"):
    """Reduced whisper-medium (2 + 2 layers, 4 heads) at the full
    config's head dim 64, so that its attentions reach the D 64 kernel
    (``wgmma`` in bf16)."""
    return dataclasses.replace(get_config("whisper-medium").reduced(),
                               dtype=dtype, head_dim=64)


def _encdec_batch(cfg, b, s, device, seed=0):
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import build_batch, step_generator
    return build_batch(cfg, SyntheticLMDataset(DataConfig(
        cfg.vocab_size, s, b)).batch(seed), step_generator(0, seed, device),
        device)


@pytest.mark.gpu
def test_reduced_encdec_gradients_kernel_route_match_plain(cuda_device):
    """The loss and every gradient of the reduced encoder-decoder at S =
    S_enc = 4096 through the flash kernel and through the plain chunked
    attention: the encoder's and the cross-attention's non-causal calls
    and the decoder's causal one, each twice (forward and recompute): 12
    launches, all simt_f32; the loss within 1e-4 relative, each gradient
    within 1e-4 of its max-abs.  (The gradients, not the parameters after
    an AdamW step: Adam's first update is g / (|g| + eps), which turns
    the float32 reordering noise of a gradient element near zero, ~5e-6
    of the largest, into a difference of up to the learning rate.)"""
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_leaves
    cfg = _reduced_encdec()
    batch = _encdec_batch(cfg, 1, 4096, cuda_device)
    out = {}
    for use_kernel in (True, False):
        params = init_params(cfg, seed=0, device=cuda_device)
        ops.reset_launch_counts()
        loss, _, grads = value_and_grad(params, cfg, batch,
                                        use_kernel=use_kernel)
        out[use_kernel] = (float(loss), tree_leaves(grads))
        want = dict.fromkeys(ops.WRAPPERS, 0)
        if use_kernel:
            want["flash_attention"] = 12
            assert ops.variant_launch_counts()["flash_attention"][
                "simt_f32"] == 12
        assert ops.launch_counts() == want
    (lk, gk), (lp, gp) = out[True], out[False]
    assert lk == pytest.approx(lp, rel=1e-4)
    for a_, b_ in zip(gk, gp):
        assert float((a_ - b_).abs().max()) <= 1e-4 * float(b_.abs().max())


@pytest.mark.gpu
def test_reduced_encdec_bf16_forward_takes_wgmma_non_causal(cuda_device):
    """The bf16 forward at S 4096: six launches, all wgmma (four of them
    non-causal), logits within 5e-2 of the plain route's."""
    from repro_torch.models import forward_train
    cfg = _reduced_encdec("bfloat16")
    params = init_params(cfg, seed=0, device=cuda_device)
    batch = _encdec_batch(cfg, 1, 4096, cuda_device)
    with torch.no_grad():
        ops.reset_launch_counts()
        got, _ = forward_train(params, cfg, batch, use_kernel=True)
        assert ops.variant_launch_counts()["flash_attention"] == {
            "simt_f32": 0, "mma_sync": 0, "wgmma": 6}
        want, _ = forward_train(params, cfg, batch, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.gpu
def test_reduced_encdec_prefill_and_decode_on_cuda(cuda_device):
    """Prefill over 4096 frames launches the kernel once an encoder layer
    (the 448-token decoder takes the direct path); decode steps after
    padding launch nothing and follow the teacher-forced forward within
    2e-4 (float32)."""
    from repro_torch.models import decode_step, forward_train, prefill
    cfg = _reduced_encdec()
    params = init_params(cfg, seed=0, device=cuda_device)
    batch = _encdec_batch(cfg, 2, 4096, cuda_device)
    seq = batch["tokens"][:, :456]
    with torch.no_grad():
        ops.reset_launch_counts()
        last, cache = prefill(params, cfg, {"frames": batch["frames"],
                                            "tokens": seq[:, :448]})
        assert ops.launch_counts()["flash_attention"] == cfg.encoder_layers
        cache = dict(cache, **{k: torch.nn.functional.pad(
            cache[k], (0, 0, 0, 0, 0, 8)) for k in ("k", "v")})
        steps = [last]
        for t in range(448, 456):
            last, cache = decode_step(params, cfg, cache,
                                      {"tokens": seq[:, t:t + 1]})
            steps.append(last)
        assert ops.launch_counts()["flash_attention"] == cfg.encoder_layers
        full, _ = forward_train(params, cfg, {"frames": batch["frames"],
                                              "tokens": seq})
    torch.testing.assert_close(torch.cat(steps, 1), full[:, 447:456],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_llava_serves_through_the_paged_kernel(cuda_device, dtype):
    """Reduced llava-next-34b on the card: vision requests through the
    server, one paged launch a layer a decode step, every request its
    tokens; a paged decode after a soft-token prefill within 2e-4
    (float32) or 5e-2 (bf16) of the plain gathered path."""
    from repro_torch.models.frontend import vision_patches
    from repro_torch.serving import ContinuousBatchingServer, Request
    cfg = dataclasses.replace(get_config("llava-next-34b").reduced(),
                              dtype=dtype)
    params = init_params(cfg, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    srv = ContinuousBatchingServer(cfg, params, 4, max_len=48, block_size=8,
                                   prefill_chunk=16, device=cuda_device)
    rng = np.random.default_rng(0)
    for rid in range(6):
        srv.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab_size, 12).astype(np.int32), max_new_tokens=6,
            soft_emb=vision_patches(gen, cfg, 1, cuda_device)))
    ops.reset_launch_counts()
    results = srv.run()
    snap = srv.snapshot()
    assert all(len(results[rid]) == 6 for rid in range(6))
    assert ops.launch_counts()["paged_attention"] == \
        snap.decode_steps * cfg.num_layers > 0
    pages = init_pages(cfg, 8, 8, cuda_device)
    bt = torch.arange(1, 5, dtype=torch.int32, device=cuda_device)[None]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 13)).astype(
        np.int32)).to(cuda_device)
    ctx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    soft = vision_patches(gen, cfg, 1, cuda_device)
    with torch.no_grad():
        forward_paged(params, cfg, pages, {"tokens": toks[:, :12],
                                           "soft_emb": soft}, bt, ctx)
        ctx = ctx + 12 + cfg.frontend_tokens
        got, want = (decode_step_paged(
            params, cfg, {k: v.clone() for k, v in pages.items()},
            {"tokens": toks[:, 12:]}, bt, ctx, use_kernel=uk)[0]
            for uk in (True, False))
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_async_save_of_cuda_state_writes_the_pre_step_state(cuda_device,
                                                            tmp_path):
    """An asynchronous checkpoint of a train state on the card, followed
    at once by an in-place AdamW step on the same tensors, holds the
    state from before the step, bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import adamw
    from repro_torch.train.state import init_train_state
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config("minicpm-2b").reduced()
    state = init_train_state(init_params(cfg, seed=0, device=cuda_device))
    before = [t.clone() for t in tree_leaves(state) if torch.is_tensor(t)]
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(1, state, block=False)
    grads = tree_map(lambda p: torch.full_like(p, 0.25), state.params)
    adamw.apply_updates(adamw.AdamWConfig(lr=1e-2), state.params, grads,
                        state.opt)
    mgr.wait()
    _, got, _ = mgr.restore(state)
    got = [t for t in tree_leaves(got) if torch.is_tensor(t)]
    now = [t for t in tree_leaves(state) if torch.is_tensor(t)]
    assert any(not torch.equal(a, b) for a, b in zip(now, before))
    for g, b in zip(got, before):
        assert torch.equal(g, b)


@pytest.mark.gpu
def test_restore_onto_cuda_keeps_dtype_and_device(cuda_device, tmp_path):
    """A checkpoint written from the CPU restores onto the card from a
    template of meta tensors: every leaf on CUDA in its dtype (the bf16
    weights, the float32 moments, the float32 MoE router), bitwise."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.train.state import init_train_state
    from repro_torch.tree import tree_leaves
    cfg = get_config("olmoe-1b-7b").reduced()
    state = init_train_state(init_params(cfg, seed=1, device="cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    template = init_train_state(init_params(cfg, device="meta"))
    step, got, _ = mgr.restore(template, device=cuda_device)
    assert step == 3
    for g, w in zip(tree_leaves(got), tree_leaves(state)):
        if not torch.is_tensor(w):
            assert g == w
            continue
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    assert {t.dtype for t in tree_leaves(got) if torch.is_tensor(t)} == \
        {torch.bfloat16, torch.float32}


@pytest.mark.gpu
def test_two_replica_fleet_shares_weights_and_gives_one_replicas_streams(
        cuda_device):
    """Two replicas on the card hold one set of weights (the same
    tensors) and each its own page pool; every greedy stream equals a
    one-replica fleet's, one paged launch a layer a decode step."""
    from repro_torch.serving import Request
    from repro_torch.serving.fleet import FleetServer
    from repro_torch.tree import tree_leaves
    cfg = get_config("minicpm-2b").reduced()
    params = init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    shared = [rng.integers(0, cfg.vocab_size, 16) for _ in range(2)]
    prompts = [np.concatenate([shared[i % 2], rng.integers(
        0, cfg.vocab_size, 3 + i)]).astype(np.int32) for i in range(8)]

    def serve(n):
        fleet = FleetServer(cfg, params, n, 4, 64, router="prefix_affinity",
                            device=cuda_device, block_size=8,
                            prefill_chunk=16)
        for rid, p in enumerate(prompts):
            assert fleet.submit(Request(rid=rid, prompt=p.copy(),
                                        max_new_tokens=6),
                                tenant=f"t{rid % 2}") is None
        ops.reset_launch_counts()
        out = fleet.run()
        steps = sum(r.decode_steps for r in fleet.snapshot().replicas)
        assert ops.launch_counts()["paged_attention"] == \
            steps * cfg.num_layers > 0
        return fleet, out

    one, want = serve(1)
    two, got = serve(2)
    assert got == want and all(len(v) == 6 for v in got.values())
    ptrs = [t.data_ptr() for t in tree_leaves(params)]
    for rep in two.replicas:
        assert rep.server.params is params
        assert [t.data_ptr() for t in tree_leaves(rep.server.params)] == ptrs
    pools = [rep.server.pages["k"].data_ptr() for rep in two.replicas]
    assert len(set(pools)) == 2


# ------------------- the block sharded over "model" -------------------- #
def _tp_model(arch="yi-34b", dtype="float32"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return cfg, init_params(cfg, seed=0, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch,s", [("yi-34b", 16), ("yi-34b", 4096),
                                    ("olmoe-1b-7b", 16),
                                    ("falcon-mamba-7b", 64)])
def test_tp_block_forward_on_cuda_threads_matches_single_rank(cuda_device,
                                                              arch, s):
    """A reduced float32 config's tree cut over 2 model-rank threads on
    the card: ``forward_train`` (no grad; at S 4096 the flash kernel at
    the per-rank heads, 2 launches a layer) gathered over the vocabulary
    within 2e-4 of the single rank's, and prefill + greedy decode with
    identical tokens."""
    from repro_torch.collectives import run_local_grid
    from repro_torch.models import decode_step, forward_train, prefill
    from repro_torch.models.layers import ambient_grid
    from repro_torch.sharding.rules import shard_params
    cfg, params = _tp_model(arch)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))

    def greedy(p):
        logits, cache = prefill(p, cfg, {"tokens": tokens[:, :16]})
        if "k" in cache:
            pad = (0, 0, 0, 0, 0, 4)
            cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                         v=torch.nn.functional.pad(cache["v"], pad))
        toks = []
        for _ in range(4):
            nxt = logits[:, -1].argmax(-1, keepdim=True).int()
            toks.append(nxt)
            logits, cache = decode_step(p, cfg, cache, {"tokens": nxt})
        return torch.cat(toks, 1)

    def rank(grid):
        local = shard_params(params, cfg, grid)
        with torch.no_grad(), ambient_grid(grid):
            logits, _ = forward_train(local, cfg, {"tokens": tokens})
            parts = grid.sub("model").all_gather(logits[None])
            return torch.cat(list(parts), -1), greedy(local)

    with torch.no_grad():
        want, _ = forward_train(params, cfg, {"tokens": tokens})
        want_toks = greedy(params)
    ops.reset_launch_counts()
    out = run_local_grid(rank, (2,), ("model",), cuda_device, timeout=120)
    if s > 2048:
        assert ops.launch_counts()["flash_attention"] == 2 * cfg.num_layers
    for logits, toks in out:
        torch.testing.assert_close(logits, want, rtol=2e-4, atol=2e-4)
        assert torch.equal(toks, want_toks)


@pytest.mark.gpu
def test_tp_block_backward_on_cuda_threads_is_refused(cuda_device):
    """A backward through the block's reductions on CUDA rank threads
    would deadlock on the autograd engine's one device thread (ROADMAP
    C15): it raises."""
    from repro_torch.collectives import run_local_grid
    from repro_torch.models.layers import ambient_grid
    from repro_torch.sharding.rules import shard_params
    from repro_torch.train.step import value_and_grad
    cfg, params = _tp_model()
    tokens = torch.zeros((1, 8), dtype=torch.int32, device=cuda_device)

    def rank(grid):
        with ambient_grid(grid):
            return value_and_grad(shard_params(params, cfg, grid), cfg,
                                  {"tokens": tokens, "labels": tokens},
                                  remat=False)

    with pytest.raises(NotImplementedError, match="C15"):
        run_local_grid(rank, (2,), ("model",), cuda_device, timeout=60)
