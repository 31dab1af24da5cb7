"""The port's CUDA kernels on the GPU, against their plain PyTorch
versions (marked ``gpu``; each test skips without a GPU and ``nvcc``).

This file imports torch, numpy and the port only, so it runs on a GPU
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in float32 and 5e-2 in bfloat16 for the paged kernel
(the reference's own); 2e-4 for float32 model logits; for the scan
kernels 1e-4 in float32, 5e-2 with bfloat16 inputs, and each gradient's
max-abs error below 1e-4 of the plain gradient's max-abs (the reference's
tests/test_kernels.py bounds).
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
    (1, 64, 48, 16),          # D not a multiple of the block's 32 channels
    (2, 100, 48, 16),         # S not a multiple of the 64-step chunk
    (2, 300, 96, 4),
    (1, 1, 8, 1),
    (2, 1024, 512, 16),       # falcon-mamba's state size, long sequence
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
    # the checkpoint of chunk k is the state after k * 64 steps
    assert hck.shape == (b, -(-s // 64), d, n)
    torch.testing.assert_close(hck[:, 0], args[5])
    if s > 64:
        _, h_64 = selective_scan_ref(*[t[:, :64] for t in args[:4]],
                                     *args[4:])
        torch.testing.assert_close(hck[:, 1], h_64, rtol=tol, atol=tol)


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
