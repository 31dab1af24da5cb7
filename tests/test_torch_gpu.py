"""The port's CUDA kernels on the GPU, against their plain PyTorch
versions (marked ``gpu``; each test skips without a GPU and ``nvcc``).

This file imports torch, numpy and the port only, so it runs on a GPU
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in float32 and 5e-2 in bfloat16 for the paged kernel
(the reference's own); 2e-4 for float32 model logits; for the scan
kernels 1e-4 in float32, 5e-2 with bfloat16 inputs, and each gradient's
max-abs error below 1e-4 of the plain gradient's max-abs (the reference's
tests/test_kernels.py bounds).  ``multi_add`` adds in the plain version's
order, so it is held bitwise; ``matmul_tiled`` within 1e-5 (float32) and
1e-2 (bfloat16, one bf16 ulp) of the plain product's max-abs.  The
collective tests use integer-valued inputs (exact in any order); the NCCL
test skips below two cards.  ``flash_attention`` within 2e-5 (float32)
and 5e-2 (bfloat16) of its plain version, lse within 1e-4, and its
gradient (plain backward) within 1e-4 of autograd's max-abs.
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
        ("head dim 256",
         _flash_inputs(1, 2, 1, 128, 256, torch.bfloat16, dev), ValueError),
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
