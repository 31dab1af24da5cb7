"""The port's CUDA kernels on the GPU, against their plain PyTorch
versions (marked ``gpu``; each test skips without a GPU and ``nvcc``).

This file imports torch, numpy and the port only, so it runs on a GPU
machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: 2e-5 in float32 and 5e-2 in bfloat16 for the kernel (the
reference's own); 2e-4 for float32 model logits.
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
