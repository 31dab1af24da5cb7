#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. environment: the card's name and power limit, torch and CUDA
   versions; every kernel is built from the sources in this checkout
   (``nvcc``, one process per source, all started together);
2. kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at its path's shapes and a few more, with the
   stated tolerances, and timed (CUDA events, L2 flushed before each
   launch, median) beside the least time the card could take (H100 SXM
   data-sheet rates; the SMs' exponential rate for the scans);
   ``matmul_tiled`` and ``flash_attention`` show which variant each case
   ran (the TMA + wgmma one for bf16 at aligned shapes / D 64 and 128),
   and the earlier kernel is timed beside the new one at the main shape;
3. serve phase: ``minicpm-2b`` at its published width (40 layers, bf16,
   random weights from ``--seed``) through ``ContinuousBatchingServer``:
   16 requests over 4 shared system prompts, 64 greedy tokens each.  The
   launch counts show the decode path went through the kernels, and one
   mid-run decode step (its state copied during the run, replayed after
   it) is held against the plain attention path and profiled;
4. train phase: ``falcon-mamba-7b`` at its published width with 8 of its
   64 layers (bf16, random weights from ``--seed``), 5 steps of batch
   2 x 4096 tokens through ``make_train_step`` on the scan kernels: loss
   per step, step time, tokens/s, peak memory, launch counts, and one
   step profiled;
5. route check: one train step of a float32 2-layer falcon-mamba-7b at
   full width (S = 1024) through the scan kernels and through the plain
   chunked scan, from the same weights and batch;
6. prefill + decode: prompts through ``prefill`` (the forward-only scan
   kernel), 8 greedy decode steps, each step's logits held against the
   teacher-forced forward;
7. collective phase: the CollectiveEngine on P = 8 ``LocalComm`` ranks
   (threads) on the one card: every algorithm the engine knows for
   reduce, allreduce, reduce_scatter, allgather, broadcast and
   all_to_all, and ``"auto"``, at 4 KB, 256 KB, 4 MB and 64 MB per rank;
   float32 integer-valued inputs bitwise equal to the sum over ranks,
   bfloat16 within 5e-2 of it.  ``auto``'s decisions are printed with
   their prices on the reference's TPU fabric model;
8. fused ring phase: ``fused_matmul_reduce_scatter`` for the TP-8
   down-projection of ``yi-34b`` at its published widths (d_ff 20480,
   d_model 7168, batch 2 x 4096 tokens, bf16) on 8 local ranks: 64
   ``matmul_tiled`` launches, all of the wgmma variant, each rank's block
   against the gathered
   path and a sampled slice against a float64 product, and one backward
   through ``matmul_tiled``;
9. NCCL phase, only with two or more cards: one ``ProcessGroupComm`` rank
   per card repeats the float32 collective checks and the fused ring;
10. dense train phase: ``minicpm-2b`` at its published width and depth
   (40 layers, bf16, random weights from ``--seed``), 5 WSD steps of
   batch 2 x 4096 tokens through ``make_train_step``, every layer's
   attention (forward and remat recompute) in the flash kernel's wgmma
   variant: loss per step, step time, tokens/s, peak memory, launch
   counts, one step profiled;
11. dense route checks: one float32 train step of a 2-layer minicpm-2b at
   full width (1 x 4096 tokens) through the flash kernel and through the
   plain chunked attention, from the same weights and batch; then the
   same for phi3-mini-3.8b (head dim 96) and mistral-nemo-12b (160);
12. dense prefill + decode: 2 x 4096-token prompts through ``prefill`` at
   full depth (one wgmma flash launch per layer), the cache padded by 8
   positions, 8 greedy ``decode_step``s, each step's logits held against
   the teacher-forced forward.

It exits non-zero, printing no result, without a GPU or outside a
checkout of the repository.  The last lines are a JSON line of per-kernel
numbers, the card's name and power limit as ``nvidia-smi`` gives them,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.collectives import (CollectiveEngine,  # noqa: E402
                                     ProcessGroupComm, get_engine,
                                     run_local)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import with_layer_units  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.collectives import shardmap_impl as impl  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_variant)
from repro_torch.kernels.matmul_tiled import (  # noqa: E402
    matmul_tiled_cuda, matmul_variant)
from repro_torch.kernels.ref import (FLASH_CHUNK,  # noqa: E402
                                     flash_attention_bwd_ref,
                                     flash_attention_ref, matmul_tiled_ref,
                                     multi_add_ref, paged_attention_ref,
                                     selective_scan_ref)
from repro_torch.models import (decode_step_paged, forward_train,  # noqa
                                init_params)
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serving import ContinuousBatchingServer, Request  # noqa
from repro_torch.train.state import init_train_state  # noqa: E402
from repro_torch.train.step import (make_decode_step,  # noqa: E402
                                    make_prefill_step, make_train_step,
                                    value_and_grad)
from repro_torch.tree import tree_leaves  # noqa: E402

#: NVIDIA H100 SXM data sheet: device memory rate, dense peak rates by the
#: inputs' type (bf16 on the tensor cores, float32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-5}
L2_FLUSH_BYTES = 128 << 20          # twice the 50 MB L2
SPIN_CYCLES = 5_000_000             # a few ms of device spin per launch

#: exponentials per SM per clock on the special-function units (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0)
SFU_PER_SM_PER_CLOCK = 16
#: the checkpoint interval of the function the checkpointing scan computes
#: (``DEFAULT_CHUNK`` of src/repro/kernels/selective_scan.py): the scan
#: bound counts hck's bytes at it, not at the kernel's own chunk, so that
#: the bound does not move with the design it judges
SCAN_REF_CHUNK = 128

SERVE_ARCH = "minicpm-2b"
SERVE = dict(batch=8, requests=16, system_prompts=4, system_len=80,
             suffix=(16, 240), new_tokens=64, block_size=16,
             prefill_chunk=128)

TRAIN_ARCH = "falcon-mamba-7b"
#: falcon-mamba-7b at full width, 8 of 64 layers (AdamW state for all 64
#: would not fit one card); train_4k's sequence with the batch cut to 2;
#: a learning rate of Mamba's own recipes' order, so that five steps of
#: the cosine schedule show the loss fall above the batch-to-batch noise
TRAIN = dict(layers=8, batch=2, seq=4096, steps=5, lr=1e-3)
#: kernel vs plain route: float32, 2 layers, S = 1024 (the plain route's
#: [B, S, d_inner, N] state expansion has to fit)
ROUTE = dict(layers=2, batch=2, seq=1024, lr=3e-4)
DECODE = dict(batch=2, prompt=64, new_tokens=8)
#: the scan kernels' timing shape: one layer of the train phase
SCAN_TIMING = (2, 4096, 8192, 16)

DENSE_ARCH = "minicpm-2b"
#: minicpm-2b at its published width and depth, train_4k's sequence with
#: the batch cut to 2, 5 steps of the WSD schedule launch/train.py picks
#: for it, at the train CLI's default learning rate (at 1e-3, the SSM
#: phase's, the loss rises over five steps on the plain attention route
#: as on the kernel route: see ``--lr-witness``)
DENSE_TRAIN = dict(layers=40, batch=2, seq=4096, steps=5, lr=3e-4)
#: ``--lr-witness``: DENSE_TRAIN at the SSM phase's learning rate through
#: the kernel route and the plain chunked route, from the same weights and
#: batches
WITNESS_LR = 1e-3
#: kernel vs plain attention route: float32, 2 layers, one 4096 sequence
DENSE_ROUTE = dict(layers=2, batch=1, seq=4096, lr=3e-4)
#: prefill at full depth, then greedy decode into 8 positions of headroom
DENSE_DECODE = dict(batch=2, prompt=4096, new_tokens=8, headroom=8)
#: the configs whose head dims (96, 160) take the mma_sync / simt_f32
#: variants: the same float32 route check as DENSE_ROUTE for each
C12_ARCHS = ("phi3-mini-3.8b", "mistral-nemo-12b")
#: flash_attention's shapes (b, h, hkv, s, d, causal, window): the train
#: phase's layer first (its timing shape); a synthetic GQA 32/8 shape at
#: D 128 (no config has it: yi-34b, 56/8 at D 128, is the nearest); the
#: full-width heads of phi3-mini-3.8b (MHA 32/32, D 96) and
#: mistral-nemo-12b (GQA 32/8, D 160, as the repo's config resolves it);
#: and the local-attention window of recurrentgemma-9b (local_window's
#: default, 2048) at minicpm-2b's heads
FLASH_CASES = (("minicpm-2b train layer", 2, 36, 36, 4096, 64, True, None),
               ("synthetic GQA 32/8 D 128 (nearest config: yi-34b 56/8)",
                1, 32, 8, 4096, 128, True, None),
               ("phi3-mini-3.8b MHA 32/32", 1, 32, 32, 4096, 96, True,
                None),
               ("mistral-nemo-12b GQA 32/8", 1, 32, 8, 4096, 160, True,
                None),
               ("sliding window 2048", 2, 36, 36, 4096, 64, True, 2048))
#: kernel vs plain lse (float32 sums of up to 4096 terms in other
#: orders, lse of magnitude ~10): 1e-4 absolute
LSE_TOL = 1e-4
#: the bf16 gradient check through the wgmma forward: 4 bf16 ulps of the
#: largest gradient
BF16_GRAD_TOL = 2.0 ** -6
#: the bf16 kernel's output, element by element, against the plain
#: version's float32 output: within one bf16 ulp of that output (rounding
#: to bf16 takes half an ulp; the other half covers a value that crosses
#: a power of two) plus O_FLOOR, which covers the float32 difference of
#: the two sums (~1e-6) where the output is near 0
O_FLOOR = 1e-5
#: deliberate faults the bf16 check must reject, at the train shape
FLASH_FAULTS = ("P rounded to bf16 before P V",
                "key i dropped from row i (causal mask off by one)",
                "first KV tile dropped for rows >= S/2")

#: collective phase: ranks on the one card, bytes per rank (the latency
#: regime, 256 KB, the trainer's default bucket_bytes, 64 MB), and every
#: algorithm the engine knows for each op, then the model's pick
COLLECTIVE_RANKS = 8
COLLECTIVE_BYTES = (4 << 10, 256 << 10, 4 << 20, 64 << 20)
ALGORITHMS = {
    "reduce": ("chain", "tree", "two_phase", "star", "autogen",
               "autogen_pipelined", "auto"),
    "allreduce": ("psum", "oneshot", "chain", "tree", "two_phase", "star",
                  "ring", "autogen", "autogen_pipelined", "auto"),
    "reduce_scatter": ("psum_scatter", "ring", "autogen", "auto"),
    "allgather": ("all_gather", "oneshot", "ring", "doubling", "autogen",
                  "auto"),
    "broadcast": ("doubling", "chain", "autogen", "auto"),
    "all_to_all": ("lax", "oneshot", "ring", "halving", "auto"),
}
BROADCAST_ROOT = 3
#: fused ring: the TP-8 down-projection of yi-34b (d_ff 20480 -> d_model
#: 7168) over 2 x 4096 tokens, bf16
FUSED_ARCH = "yi-34b"
FUSED = dict(tp=8, batch=2, seq=4096)
#: each rank's block of the ring vs the gathered path, and a sampled slice
#: vs float64: both sides round to bf16 at each of the 8 hops (the block
#: GEMM's output and the sum), at most 16 roundings of half a bf16 ulp
#: (2^-8) of the largest partial, relative to the result's max-abs
FUSED_TOL = 16 * 2.0 ** -8
#: the shapes of multi_add (one 4 MB bucket from 8 ranks,
#: K = 2, 32, bf16, ragged N) and of matmul_tiled (one ring step first)
MULTI_ADD_CASES = (("one 4 MB fp32 bucket from 8 ranks", 8, 1 << 20,
                    torch.float32),
                   ("K = 2", 2, 1 << 20, torch.float32),
                   ("K = 32", 32, 1 << 20, torch.float32),
                   ("bf16", 8, 1 << 20, torch.bfloat16),
                   ("ragged N", 8, 1_000_003, torch.float32))
MATMUL_CASES = (("one ring step of the fused phase", 1024, 2560, 7168,
                 torch.bfloat16),
                ("the same in float32", 1024, 2560, 7168, torch.float32),
                ("ragged M, N (16-byte rows)", 1000, 2560, 7000,
                 torch.bfloat16),
                ("ragged K, N (element loads)", 1000, 2555, 7001,
                 torch.bfloat16))
#: matmul_tiled vs its plain version, relative to the plain product's
#: max-abs: float32 adds in another order over K = 2560; bf16 rounds the
#: float32 sum once, at most one bf16 ulp (2^-7 of the value) apart
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------- timing -------------------------------- #
def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms.  Before every launch the L2
    cache is flushed (the serving path finds its KV pool cold: the other
    39 layers pass through L2 between two calls of one layer) and the
    card spins for a few ms, so that the host has enqueued all of ``fn``
    before the start event fires: the time is the device's, not the
    Python wrapper's."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_step(fn) -> str:
    """One call of ``fn`` under ``torch.profiler``: host wall time, the
    device kernels it ran, their busy time (union of their intervals)
    and the idle share of the device span, and the top kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return f"host wall {wall_ms:.2f} ms; the profiler saw no device time"
    busy, cur_s, cur_e, by_name = 0.0, spans[0][0], spans[0][1], {}
    for s0, e0, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    tops = "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top)
    return (f"host wall {wall_ms:.2f} ms (profiled) | {len(spans)} device "
            f"kernels | device busy {busy / 1e3:.3f} ms of a "
            f"{span / 1e3:.3f} ms span (idle share {1 - busy / span:.1%}) "
            f"| top: {tops}")


# -------------------------- kernel phase ----------------------------- #
def paged_case(b, h, hkv, d, bs, n_blocks, lengths, dtype, seed):
    """Inputs of one paged-attention case on the card.  Each row's table
    holds its own blocks, then one more block of live data past its
    length (a stale block the kernel must not read)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (n_blocks, bs, hkv, d)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    need = [math.ceil(n / bs) for n in lengths]
    m = max(need) + 1
    assert sum(need) + b < n_blocks, "pool too small for the case"
    ids = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
           + 1).tolist()
    tables = np.zeros((b, m), np.int32)
    for row, k in enumerate(need):
        tables[row, :k + 1] = [ids.pop() for _ in range(k + 1)]
    bt = torch.from_numpy(tables).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lens


def paged_bound(q, kp, bt, lens):
    """(least ms, "bytes" | "operations") of one call: the K and V rows
    of the tokens this run attends over, the queries, the output and the
    tables moved once; 4*H*D operations per token at the inputs' type."""
    b, h, d = q.shape
    hkv = kp.shape[2]
    esize = q.element_size()
    tokens = int(lens.clamp(min=0).sum())
    nbytes = (2 * tokens * hkv * d * esize + 2 * q.numel() * esize
              + 4 * bt.numel() + 4 * lens.numel())
    ops_ = 4 * tokens * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_ / PEAK_OPS_PER_S[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gather_sdpa(q, kp, vp, bt, lens):
    """Context only: a gather of the pages, then one
    ``scaled_dot_product_attention`` call (two calls, MHA only)."""
    n, bs, hkv, d = kp.shape
    b, m = bt.shape
    idx = (bt.long()[:, :, None] * bs
           + torch.arange(bs, device="cuda")).reshape(b, m * bs)
    k = kp.view(n * bs, hkv, d)[idx].transpose(1, 2)
    v = vp.view(n * bs, hkv, d)[idx].transpose(1, 2)
    mask = (torch.arange(m * bs, device="cuda")[None, None, None, :]
            < lens[:, None, None, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask)


def kernel_phase(seed: int) -> dict:
    cases = [
        # (label, b, h, hkv, d, bs, n_blocks, lengths, dtype)
        ("minicpm-2b decode (serving shape)", 8, 36, 36, 64, 16, 201,
         [1, 0, 37, 100, 157, 211, 290, 383], torch.bfloat16),
        ("GQA 32/8, head dim 128", 8, 32, 8, 128, 16, 201,
         [5, 64, 1, 0, 129, 250, 311, 384], torch.bfloat16),
        ("minicpm-2b shape, float32", 8, 36, 36, 64, 16, 201,
         [1, 0, 37, 100, 157, 211, 290, 383], torch.float32),
    ]
    max_err = 0.0
    main = None
    for i, (label, b, h, hkv, d, bs, nb, lengths, dtype) in enumerate(cases):
        q, kp, vp, bt, lens = paged_case(b, h, hkv, d, bs, nb, lengths,
                                         dtype, seed + i)
        got = ops.paged_attention(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        want = paged_attention_ref(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        live = lens > 0
        assert torch.all(got[~live] == 0), "length-0 rows must give zeros"
        err = float((got[live].float() - want[live].float()).abs().max())
        assert err <= TOL[dtype], (label, err, TOL[dtype])
        # clobber every slot past each row's length (the stale block and
        # the tail of the last partial block): the output must not move
        kp2, vp2 = kp.clone(), vp.clone()
        for row, n in enumerate(lengths):
            for j, blk in enumerate(bt[row].tolist()):
                lo = max(n - j * bs, 0)
                if lo < bs:
                    kp2[blk, lo:] = 1e4
                    vp2[blk, lo:] = -1e4
        again = ops.paged_attention(q, kp2, vp2, bt, lens)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{label}: read past a length"
        max_err = max(max_err, err)
        log(f"kernel paged_attention {label}: B={b} H={h} Hkv={hkv} D={d} "
            f"bs={bs} {str(dtype).split('.')[-1]} lengths={lengths} "
            f"max_abs_err={err:.3e} (tol {TOL[dtype]:.0e}) stale-safe")
        if main is None:
            main = (q, kp, vp, bt, lens)
    q, kp, vp, bt, lens = main
    ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, lens))
    plain_ms = time_ms(lambda: paged_attention_ref(q, kp, vp, bt, lens))
    sdpa_ms = time_ms(lambda: gather_sdpa(q, kp, vp, bt, lens))
    bound_ms, bound_by = paged_bound(q, kp, bt, lens)
    log(f"kernel paged_attention timing at the serving shape: kernel "
        f"{ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound_ms:.4f} ms "
        f"({bound_by}; {HBM_BYTES_PER_S / 1e12} TB/s H100 SXM data sheet) "
        f"| {bound_ms / ms:.1%} of bound")
    log(f"library_ms: null -- no single PyTorch call computes paged "
        f"attention; context only, page gather + "
        f"scaled_dot_product_attention (two calls): {sdpa_ms:.4f} ms")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:121",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---------------------- selective-scan kernels ------------------------ #
def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_case(b, s, d, n, dtype, seed):
    """Scan inputs on the card: dt = softplus(normal), x, B, C, h0
    normal, A = -exp(0.5 normal) (the reference's kernel tests)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(f(b, s, d))
    ins = [t.to(dtype) for t in (dt, f(b, s, d), f(b, s, n), f(b, s, n))]
    return ins + [-torch.exp(0.5 * f(d, n)), f(b, d, n)]


def scan_bound(kind, b, s, d, n, esize):
    """(least ms, "bytes" | "operations") of one scan call: each input
    read once and each output written once at 3.35 TB/s; one exponential
    per (batch, step, channel, state) on the SFUs (16 per SM per clock at
    the card's maximum SM clock).  hck is counted at the reference's
    checkpoint interval, SCAN_REF_CHUNK."""
    bsd, bsn, dn, bdn = b * s * d, b * s * n, d * n, b * d * n
    hck = b * -(-s // SCAN_REF_CHUNK) * d * n
    if kind == "bwd":       # dt, x, dy, B, C, A, hck, dh_final -> grads
        nbytes = 4 * (3 * bsd + 2 * bsn + dn + hck + bdn
                      + 2 * bsd + 2 * bsn + dn + bdn)
    else:                   # dt, x, B, C, A, h0 -> y, h_final (+ hck)
        nbytes = (esize * (3 * bsd + 2 * bsn) + 4 * (dn + 2 * bdn)
                  + (4 * hck if kind == "ckpt" else 0))
    props = torch.cuda.get_device_properties(0)
    exp_rate = (props.multi_processor_count * SFU_PER_SM_PER_CLOCK
                * max_sm_clock_hz())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = b * s * d * n / exp_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grad_errors(args, w, v):
    """Gradients of sum(y * w) + sum(h_final * v) through the kernel pair
    and through autograd of the plain recurrence: (max abs error, max of
    abs error over the reference's max abs, per input)."""
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        fn = (ss.selective_scan_trainable if route == "kernel"
              else selective_scan_ref)
        y, hf = fn(*leaves)
        grads[route] = torch.autograd.grad((y * w).sum() + (hf * v).sum(),
                                           leaves)
        del y, hf, leaves
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    for k, r in zip(grads["kernel"], grads["plain"]):
        e = float((k - r).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / (float(r.abs().max()) + 1e-9))
    return abs_err, rel_err


def scan_kernel_phase(seed: int) -> list:
    """Rows 5-7 of the kernel table: the forward (no checkpoints), the
    checkpointing forward and the backward, against the plain recurrence
    on the card, then held to it again and timed at one layer of the
    train phase."""
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    cases = [
        # (label, b, s, d, n, dtype, gradients, absolute check)
        ("training layer width, S 1024", 2, 1024, 8192, 16, torch.float32,
         True, True),
        ("ragged: S 100, D 48", 2, 100, 48, 16, torch.float32, True, True),
        ("bf16 inputs", 2, 512, 1024, 16, torch.bfloat16, False, True),
        # |y| reaches 16-32 here, where one bf16 ulp is 0.125: held element
        # by element to the float32 plain output (bf16_ratio), not to 5e-2
        ("bf16 inputs, training layer width, S 1024", 2, 1024, 8192, 16,
         torch.bfloat16, False, False),
        ("ragged: S 77, D 200, N 4", 2, 77, 200, 4, torch.float32, True,
         True),
        ("rows not 16-byte aligned: S 50, D 45, N 1", 2, 50, 45, 1,
         torch.float32, True, True),
    ]
    err = {"fwd": 0.0, "ckpt": 0.0, "bwd": 0.0}
    for i, (label, b, s, d, n, dtype, grads, absolute) in enumerate(cases):
        args = scan_case(b, s, d, n, dtype, seed + 100 + i)
        y5, h5 = ss.selective_scan(*args)
        y6, h6, hck = ss.selective_scan_fwd_ckpt(*args)
        torch.cuda.synchronize()
        y_r, h_r = selective_scan_ref(*args)
        # bf16: the plain version on float32 copies of the same values, its
        # output before the cast (each kernel y within one bf16 ulp of it)
        y_f = (selective_scan_ref(*[t.float() for t in args])[0]
               if dtype == torch.bfloat16 else None)
        torch.cuda.synchronize()
        msg = []
        for kind, y, h in (("fwd", y5, h5), ("ckpt", y6, h6)):
            e = max(float((y.float() - y_r.float()).abs().max()),
                    float((h - h_r).abs().max()))
            assert not absolute or e <= tol[dtype], (label, kind, e)
            assert float((h - h_r).abs().max()) <= tol[dtype], (label, kind)
            err[kind] = max(err[kind], e)
            msg.append(f"{kind} max_abs_err {e:.3e}")
            if y_f is not None:
                ratio = bf16_ratio(y, y_f)
                assert ratio <= 1.0, (label, kind, ratio)
                msg.append(f"{kind} y max |err| / (1 bf16 ulp of the float32 "
                           f"plain output + {O_FLOOR:.0e}) {ratio:.4f} "
                           f"(tol 1)")
        assert torch.equal(hck[:, 0], args[5]), "hck[:, 0] must be h0"
        if grads:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 200 + i)
            w = torch.randn(y_r.shape, generator=gen, device="cuda")
            v = torch.randn(h_r.shape, generator=gen, device="cuda")
            abs_e, rel_e = grad_errors(args, w, v)
            assert rel_e < 1e-4, (label, "gradients", rel_e)
            err["bwd"] = max(err["bwd"], abs_e)
            msg.append(f"bwd max_abs_err {abs_e:.3e} (max over inputs of "
                       f"err / max|ref| {rel_e:.3e}, tol 1e-4)")
        log(f"kernel selective_scan {label}: B={b} S={s} D={d} N={n} "
            f"{str(dtype).split('.')[-1]} | " + " | ".join(msg)
            + f" ({'' if absolute else 'h_final '}tol {tol[dtype]:.0e})")
        del args, y5, h5, y6, h6, hck, y_r, h_r, y_f
    torch.cuda.empty_cache()

    # the main path's shape: the kernels' outputs are held against the
    # plain forward and backward that the timing below runs anyway, before
    # any kernel is timed
    b, s, d, n = SCAN_TIMING
    args = scan_case(b, s, d, n, torch.float32, seed)
    y5, h5 = ss.selective_scan(*args)
    y6, h6, hck = ss.selective_scan_fwd_ckpt(*args)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 300)
    dy = torch.randn((b, s, d), generator=gen, device="cuda")
    dhf = torch.randn((b, d, n), generator=gen, device="cuda")
    g_kernel = ss.selective_scan_bwd(*args[:5], hck, dy, dhf)
    leaves = [t.clone().requires_grad_() for t in args]
    y, hf = selective_scan_ref(*leaves)
    torch.cuda.synchronize()
    msg = []
    for kind, yk, hk in (("fwd", y5, h5), ("ckpt", y6, h6)):
        e = max(float((yk - y.detach()).abs().max()),
                float((hk - hf.detach()).abs().max()))
        assert e <= tol[torch.float32], ("SCAN_TIMING", kind, e)
        err[kind] = max(err[kind], e)
        msg.append(f"{kind} max_abs_err {e:.3e}")
    assert torch.equal(hck[:, 0], args[5]), "hck[:, 0] must be h0"
    del y5, h5, y6, h6
    # the plain backward's timed call keeps its gradients: 1 rep (~5 s)
    g_plain = []
    plain_bwd = time_ms(lambda: g_plain.append(torch.autograd.grad(
        (y, hf), leaves, (dy, dhf), retain_graph=True)),
        reps=1, warmup=1)
    abs_e = rel_e = 0.0
    for k, r in zip(g_kernel, g_plain[-1]):
        e = float((k - r).abs().max())
        abs_e = max(abs_e, e)
        rel_e = max(rel_e, e / (float(r.abs().max()) + 1e-9))
    assert rel_e < 1e-4, ("SCAN_TIMING", "gradients", rel_e)
    err["bwd"] = max(err["bwd"], abs_e)
    msg.append(f"bwd max_abs_err {abs_e:.3e} (max over inputs of err / "
               f"max|ref| {rel_e:.3e}, tol 1e-4)")
    log(f"kernel selective_scan main path's shape: B={b} S={s} D={d} N={n} "
        f"float32 | " + " | ".join(msg) + " | hck[:, 0] == h0 (tol 1e-04)")
    del y, hf, leaves, g_kernel, g_plain
    torch.cuda.empty_cache()
    ms = {"fwd": time_ms(lambda: ss.selective_scan(*args), reps=20),
          "ckpt": time_ms(lambda: ss.selective_scan_fwd_ckpt(*args),
                          reps=20),
          "bwd": time_ms(lambda: ss.selective_scan_bwd(
              *args[:5], hck, dy, dhf), reps=20)}
    # the plain versions are yardsticks of arithmetic, not of speed, and
    # the slow part of the run: 3 forward reps, 1 backward rep (above)
    plain_reps = {"fwd": 3, "bwd": 1}
    with torch.no_grad():
        plain_fwd = time_ms(lambda: selective_scan_ref(*args),
                            reps=plain_reps["fwd"], warmup=1)
    plain = {"fwd": plain_fwd, "ckpt": plain_fwd, "bwd": plain_bwd}
    rows = {}
    names = {"fwd": ("selective_scan", 84), "ckpt":
             ("selective_scan_fwd_ckpt", 221),
             "bwd": ("selective_scan_bwd", 257)}
    plain_note = {"fwd": "", "ckpt": ", forward only, shared with row 5",
                  "bwd": ", autograd backward of the recurrence"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, (name, line) in names.items():
        bound_ms, bound_by = scan_bound(kind, b, s, d, n, 4)
        reps = plain_reps["bwd" if kind == "bwd" else "fwd"]
        info = ss.describe(kind, torch.float32, n)
        blocks = -(-d // info["channels"]) * b
        waves = blocks / (info["blocks_per_sm"] * sms)
        log(f"kernel {name} timing at one train-phase layer (B={b} S={s} "
            f"D={d} N={n} float32): kernel {ms[kind]:.4f} ms (median of "
            f"20) | plain {plain[kind]:.4f} ms (median of {reps}"
            f"{plain_note[kind]}) | bound {bound_ms:.4f} ms ({bound_by}) | "
            f"{bound_ms / ms[kind]:.1%} of bound")
        log(f"kernel {name} launch at that shape: {info['registers']} "
            f"registers a thread, {info['spill_bytes']} bytes spilled, "
            f"{info['threads']} threads and {info['smem_bytes']} bytes of "
            f"shared memory a block ({info['channels']} channels), "
            f"{info['blocks_per_sm']} blocks per SM | {blocks} blocks on "
            f"{sms} SMs = {waves:.3f} waves")
        rows[kind] = {"name": name, "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/"
                                "selective_scan.cu",
                      "replaces": f"src/repro/kernels/selective_scan.py:"
                                  f"{line}",
                      "launches": 0, "max_abs_err": err[kind],
                      "ms": ms[kind], "plain_ms": plain[kind],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
    log("library_ms: null for the three scan kernels -- no single PyTorch "
        "call computes a selective scan (torch has no associative scan "
        "operator; the plain route is a loop of elementwise kernels)")
    return [rows["fwd"], rows["ckpt"], rows["bwd"]]


# --------------------------- serve phase ----------------------------- #
def make_requests(cfg, seed: int):
    rng = np.random.default_rng(seed)
    system = [rng.integers(0, cfg.vocab_size, SERVE["system_len"])
              for _ in range(SERVE["system_prompts"])]
    reqs = []
    for rid in range(SERVE["requests"]):
        sfx = rng.integers(0, cfg.vocab_size,
                           int(rng.integers(*SERVE["suffix"], endpoint=True)))
        prompt = np.concatenate([system[rid % len(system)], sfx])
        reqs.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=SERVE["new_tokens"]))
    return reqs


def snapshot_decode(server) -> dict:
    """The next decode step's inputs for the running rows that have room
    for their next token, and a copy of the live KV pool: the mid-run
    state ``decode_check`` replays once the run is over, so the check
    does not stall the requests being served."""
    rows = [r for _, r in server.scheduler.running()
            if len(r.table.blocks) * server.block_size > r.ctx_len]
    assert rows, "no running request to check"
    bt = np.zeros((len(rows), server.max_blocks_per_seq), np.int32)
    for i, r in enumerate(rows):
        bt[i, :len(r.table.blocks)] = r.table.blocks
    return {"batch": {"tokens": torch.tensor([[r.out[-1]] for r in rows],
                                             dtype=torch.int32).cuda()},
            "block_tables": torch.from_numpy(bt).cuda(),
            "ctx_lens": torch.tensor([r.ctx_len for r in rows],
                                     dtype=torch.int32).cuda(),
            "pages": {k: v.clone() for k, v in server.pages.items()}}


def decode_check(server, snap: dict) -> float:
    """The snapshot's decode step through the kernel and through the
    plain gathered attention, each on its own copy of the pool; returns
    the largest logit difference.  Also times the kernel-path step and
    profiles it."""
    def step(use_kernel):
        pages = {k: v.clone() for k, v in snap["pages"].items()}
        torch.cuda.synchronize()
        return lambda: decode_step_paged(
            server.params, server.cfg, pages, snap["batch"],
            snap["block_tables"], snap["ctx_lens"],
            use_kernel=use_kernel)[0]

    rows = snap["ctx_lens"].shape[0]
    logits = {}
    for use_kernel in (True, False):
        run = step(use_kernel)
        t0 = time.perf_counter()
        lg = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        assert torch.isfinite(lg).all(), "non-finite decode logits"
        logits[use_kernel] = lg
        log(f"decode step of {rows} rows, "
            f"{'kernel' if use_kernel else 'plain'} attention: host wall "
            f"{ms:.2f} ms")
    log(f"profile of one decode step (kernel path): "
        f"{profile_step(step(True))}")
    return float((logits[True] - logits[False]).abs().max())


def serve_phase(seed: int, kernel_row: dict) -> None:
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    log(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; {cfg.param_count() / 1e9:.3f}"
        f"B params, random weights (seed {seed}) in "
        f"{time.perf_counter() - t0:.1f} s")
    max_len = (SERVE["system_len"] + SERVE["suffix"][1] + SERVE["new_tokens"]
               + SERVE["block_size"])
    kw = dict(block_size=SERVE["block_size"],
              prefill_chunk=SERVE["prefill_chunk"], device="cuda")
    # warm-up on a throwaway server: cuBLAS handles, allocator, kernel
    # library load -- set-up, not serving time
    warm = ContinuousBatchingServer(cfg, params, 1, max_len=64, **kw)
    warm.submit(Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                        max_new_tokens=3))
    warm.run()
    del warm
    server = ContinuousBatchingServer(cfg, params, SERVE["batch"],
                                      max_len=max_len, seed=seed, **kw)
    pool_gb = sum(p.numel() * p.element_size()
                  for p in server.pages.values()) / 1e9
    log(f"KV pool: {server.allocator.num_blocks} blocks of "
        f"{SERVE['block_size']} tokens, {pool_gb:.3f} GB")
    reqs = make_requests(cfg, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for req in reqs:
        server.submit(req)
    results = server.run(max_steps=40)
    t_probe = time.perf_counter()
    probe = snapshot_decode(server)
    t_probe = time.perf_counter() - t_probe
    results.update(server.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    err = decode_check(server, probe)   # launches here do not count
    del probe

    snap = server.snapshot()
    assert sorted(results) == list(range(SERVE["requests"]))
    for rid, toks in results.items():
        assert len(toks) == SERVE["new_tokens"], (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks), rid
    assert err <= TOL[torch.bfloat16], \
        f"mid-run decode logits kernel vs plain differ by {err}"
    assert snap.cached_prefix_tokens > 0, "prefix cache never hit"
    want = snap.decode_steps * cfg.num_layers
    assert counts["paged_attention"] == want, (counts, want)
    kernel_row["launches"] = counts["paged_attention"]
    tokens = sum(len(v) for v in results.values())
    log(f"serve: {len(results)} requests x {SERVE['new_tokens']} tokens, "
        f"{tokens} tokens in {wall:.3f} s = {tokens / (wall - t_probe):.1f} "
        f"tok/s (excluding {t_probe:.3f} s to copy the mid-run state)")
    log(f"serve: ttft p50 {snap.ttft_p50_ms:.1f} ms p99 "
        f"{snap.ttft_p99_ms:.1f} ms | decode steps {snap.decode_steps} | "
        f"prefill chunks {snap.prefill_chunks} | preemptions "
        f"{snap.preemptions} | prefill tokens computed "
        f"{snap.prefill_tokens_computed} | cached prefix tokens "
        f"{snap.cached_prefix_tokens} | peak kv occupancy "
        f"{snap.kv_peak_occupancy:.3f}")
    log(f"serve: paged_attention launches {counts['paged_attention']} = "
        f"{snap.decode_steps} decode steps x {cfg.num_layers} layers | "
        f"mid-run decode logits kernel vs plain max_abs_err {err:.3e} "
        f"(tol 5e-2) | max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")


# --------------------------- train phase ----------------------------- #
def lm_batch(cfg, batch: int, seq: int, step: int) -> dict:
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, batch))
    return {k: torch.from_numpy(v).cuda()
            for k, v in data.batch(step).items()}


def timed_step(step_fn, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])           # waits for the device
    torch.cuda.synchronize()
    return state, metrics, loss, time.perf_counter() - t0


def train_phase(seed: int, rows: dict) -> None:
    cfg = with_layer_units(get_config(TRAIN_ARCH), TRAIN["layers"])
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"train {cfg.name}: {cfg.num_layers} of 64 layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, ssm_state {cfg.ssm_state}, "
        f"dt_rank {cfg.dt_rank}, conv {cfg.ssm_conv}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {cfg.param_count() / 1e9:.3f}B "
        f"params, random weights (seed {seed}) and AdamW state in "
        f"{time.perf_counter() - t0:.1f} s")
    steps = TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="cosine")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, TRAIN["batch"], TRAIN["seq"], i)
               for i in range(steps + 1)]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        walls.append(wall)
        log(f"train step {i}: loss {loss:.4f} | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | lr {metrics['lr']:.2e} | "
            f"wall {wall * 1e3:.1f} ms | {tokens / wall:.1f} tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want.update(selective_scan_fwd_ckpt=2 * cfg.num_layers * steps,
                selective_scan_bwd=cfg.num_layers * steps)
    assert counts == want, (counts, want)
    rows["selective_scan_fwd_ckpt"]["launches"] = counts[
        "selective_scan_fwd_ckpt"]
    rows["selective_scan_bwd"]["launches"] = counts["selective_scan_bwd"]
    steady = float(np.median(walls[1:]))
    log(f"train: {steps} steps of {TRAIN['batch']} x {TRAIN['seq']} "
        f"tokens, loss {losses[0]:.4f} -> {losses[-1]:.4f} | step wall "
        f"median of steps 1-{steps - 1} {steady * 1e3:.1f} ms (step 0 "
        f"{walls[0] * 1e3:.1f} ms) = {tokens / steady:.1f} tok/s | "
        f"max_memory_allocated {peak_gb:.3f} GB")
    log(f"train: launches per step: selective_scan_fwd_ckpt "
        f"{counts['selective_scan_fwd_ckpt'] // steps} (2 x "
        f"{cfg.num_layers} layers: forward and remat) | selective_scan_bwd "
        f"{counts['selective_scan_bwd'] // steps} (one per layer)")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one train step (kernel route): "
        f"{profile_step(one_step)}")


# ------------------------- route check phase ------------------------- #
def route_phase(seed: int) -> None:
    """One train step of a float32 2-layer falcon-mamba-7b at full width
    through the scan kernels and through the plain chunked scan, from the
    same weights and batch; first the gradients themselves (Adam's first
    update follows the gradient's sign, not its size)."""
    cfg = dataclasses.replace(
        with_layer_units(get_config(TRAIN_ARCH), ROUTE["layers"]),
        dtype="float32")
    opt_cfg = AdamWConfig(lr=ROUTE["lr"], warmup_steps=1, total_steps=5)
    batch = lm_batch(cfg, ROUTE["batch"], ROUTE["seq"], 0)
    out = {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
        _, _, grads = value_and_grad(state.params, cfg, batch,
                                     use_kernel=use_kernel)
        step_fn = make_train_step(cfg, opt_cfg, use_kernel=use_kernel)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, metrics, loss, wall = timed_step(step_fn, state, batch)
        counts = ops.launch_counts()
        if use_kernel:
            assert counts["selective_scan_bwd"] == cfg.num_layers, counts
        else:
            assert not any(counts.values()), counts
        out[use_kernel] = (loss, float(metrics["grad_norm"]),
                           tree_leaves(grads), tree_leaves(state.params))
        log(f"route {'kernel' if use_kernel else 'plain '}: loss "
            f"{loss:.6f} | grad_norm {out[use_kernel][1]:.6f} | step wall "
            f"{wall * 1e3:.1f} ms | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del state, step_fn, grads
        torch.cuda.empty_cache()
    (lk, nk, gk, pk), (lp, n_p, gp, pp) = out[True], out[False]
    d_loss = abs(lk - lp) / abs(lp)
    d_gnorm = abs(nk - n_p) / abs(n_p)
    d_grad = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                 for a, b in zip(gk, gp))
    d_param = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    # float32 throughout: the two scans add in other orders (sequential
    # recurrence vs doubling prefix), ~1e-6 relative per element; each
    # gradient is held to the reference's bound for the scan's (max-abs
    # error below 1e-4 of its max-abs); Adam's eps (1e-8) bounds what the
    # noise can do to one update
    assert d_loss < 1e-4 and d_gnorm < 1e-4 and d_grad < 1e-4 \
        and d_param < 1e-5, (d_loss, d_gnorm, d_grad, d_param)
    log(f"route kernel vs plain ({cfg.num_layers} layers, float32, "
        f"{ROUTE['batch']} x {ROUTE['seq']}): loss rel diff {d_loss:.3e} "
        f"(tol 1e-4) | grad_norm rel diff {d_gnorm:.3e} (tol 1e-4) | "
        f"gradients, max over leaves of err / max|plain| {d_grad:.3e} (tol "
        f"1e-4) | params after the update max abs diff {d_param:.3e} (tol "
        f"1e-5)")


# ------------------------ prefill + decode --------------------------- #
def decode_phase(seed: int, rows: dict) -> None:
    """Prompts through ``prefill`` (forward-only scan kernel), then greedy
    decode steps, each held against the teacher-forced forward."""
    cfg = dataclasses.replace(
        with_layer_units(get_config(TRAIN_ARCH), ROUTE["layers"]),
        dtype="float32")
    params = init_params(cfg, seed=seed, device="cuda")
    prompt = lm_batch(cfg, DECODE["batch"], DECODE["prompt"], 1)["tokens"]
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompt})
    steps = [logits]
    toks = []
    for _ in range(DECODE["new_tokens"]):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = decode_step(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want.update(selective_scan=cfg.num_layers)
    assert counts == want, (counts, want)
    rows["selective_scan"]["launches"] = counts["selective_scan"]
    seq = torch.cat([prompt] + toks, dim=1)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": seq},
                                use_kernel=True)
    got = torch.cat(steps, dim=1)
    want_logits = full[:, DECODE["prompt"] - 1:]
    err = float((got - want_logits).abs().max())
    # float32: the same arithmetic in other GEMM shapes (M = 2 per decode
    # step vs M = 2 x 72) and summation orders
    assert torch.isfinite(got).all() and err < 1e-3, err
    assert int(cache["pos"]) == DECODE["prompt"] + DECODE["new_tokens"]
    log(f"prefill + decode ({cfg.num_layers} layers, float32): prompts "
        f"{DECODE['batch']} x {DECODE['prompt']}, {DECODE['new_tokens']} "
        f"greedy tokens in {wall * 1e3:.1f} ms | selective_scan launches "
        f"{counts['selective_scan']} (prefill, one per layer) | logits vs "
        f"teacher-forced forward max_abs_err {err:.3e} (tol 1e-3)")


# ------------------------- flash attention ---------------------------- #
def flash_case(b, h, hkv, s, d, dtype, seed):
    """Normal q [b, h, s, d] and k, v [b, hkv, s, d] on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def kept_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs of one head that the mask keeps."""
    q = np.arange(s)
    lo = np.zeros(s, np.int64) if window is None else \
        np.maximum(q - window + 1, 0)
    hi = q + 1 if causal else np.full(s, s)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(q, k, causal, window):
    """(least ms, "bytes" | "operations") of one call: 4 D operations per
    kept (query, key) pair and query head (Q K^T and P V) at the inputs'
    type's peak; q, k, v read once, o and lse written once."""
    b, h, s, d = q.shape
    ops_ = 4 * d * kept_pairs(s, causal, window) * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * b * h * s
    t_ops = ops_ / PEAK_OPS_PER_S[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa(q, k, v, causal, window):
    """Context only: one ``scaled_dot_product_attention`` call (GQA by
    ``enable_gqa``; a window as a boolean mask)."""
    mask = None
    if window is not None:
        s = q.shape[2]
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] > i[:, None] - window)
        if causal:
            mask &= i[None, :] <= i[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=k.shape[1] != q.shape[1])


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element (8 significant
    bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def bf16_ratio(o: torch.Tensor, o_ref: torch.Tensor) -> float:
    """The bf16 check: the largest |o - o_ref| / (bf16_ulp(o_ref) +
    O_FLOOR) over the elements; it passes at 1 or less."""
    return float(((o.float() - o_ref).abs()
                  / (bf16_ulp(o_ref) + O_FLOOR)).max())


def flash_faulty(q, k, v, fault: str) -> torch.Tensor:
    """Causal attention with one head per KV head, as the plain version
    computes it in float32, with one deliberate fault of FLASH_FAULTS;
    the output rounded to q's dtype."""
    s = q.shape[2]
    qf, kf, vf = q.float() / q.shape[3] ** 0.5, k.float(), v.float()
    keys = torch.arange(s, device=q.device)[None, :]
    outs = []
    for q0 in range(0, s, FLASH_CHUNK):
        rows = torch.arange(q0, q0 + FLASH_CHUNK, device=q.device)[:, None]
        keep = keys <= rows
        if fault == FLASH_FAULTS[1]:
            keep = (keys < rows) | (keys + rows == 0)
        elif fault == FLASH_FAULTS[2]:
            keep &= (rows < s // 2) | (keys >= 64)
        logits = qf[:, :, q0:q0 + FLASH_CHUNK] @ kf.transpose(-1, -2)
        p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        if fault == FLASH_FAULTS[0]:
            p = p.to(torch.bfloat16).float()
        outs.append(p @ vf)
    return torch.cat(outs, dim=2).to(q.dtype)


def flash_kernel_phase(seed: int) -> dict:
    """Row 4 of the kernel table: the flash kernel against its plain
    version on the card (output and lse) at the train, GQA and window
    shapes in bf16 and float32, timed beside its bound and one PyTorch
    call; the bf16 check shown to reject deliberate faults; the gradient
    of FlashAttentionFn against autograd through the plain version in
    float32, and in bf16 (the wgmma forward) against the plain backward;
    the plain backward timed at the train shape."""
    err, main = 0.0, None
    for i, (label, b, h, hkv, s, d, causal, window) in enumerate(
            FLASH_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_case(b, h, hkv, s, d, dtype, seed + 500 + i)
            variant = flash_variant(dtype, d)
            ops.reset_launch_counts()
            o, lse = flash_attention_cuda(q, k, v, causal, window)
            torch.cuda.synchronize()
            variants = ops.variant_launch_counts()["flash_attention"]
            assert variants == {**dict.fromkeys(variants, 0), variant: 1}, \
                (label, variant, variants)
            # float32 inputs hold the same values: the plain output before
            # its cast to q's dtype
            o_ref, lse_ref = flash_attention_ref(q.float(), k.float(),
                                                 v.float(), causal, window)
            torch.cuda.synchronize()
            e_o = float((o.float() - o_ref).abs().max())
            e_l = float((lse - lse_ref).abs().max())
            if dtype == torch.bfloat16:
                ratio = bf16_ratio(o, o_ref)
                check = (f"o max |err| / (1 bf16 ulp of the float32 plain "
                         f"output + {O_FLOOR:.0e}) {ratio:.4f} (tol 1) | o "
                         f"max_abs_err {e_o:.3e}")
                assert ratio <= 1.0 and e_l <= LSE_TOL, (label, dtype,
                                                         ratio, e_l)
            else:
                check = f"o max_abs_err {e_o:.3e} (tol {TOL[dtype]:.0e})"
                assert e_o <= TOL[dtype] and e_l <= LSE_TOL, (label, dtype,
                                                              e_o, e_l)
            if i == 0 and dtype == torch.bfloat16:
                faults = {f: bf16_ratio(flash_faulty(q, k, v, f), o_ref)
                          for f in FLASH_FAULTS}
                assert min(faults.values()) > 1.0, faults
                log(f"kernel flash_attention bf16 check vs deliberate "
                    f"faults at the {label} shape: sound kernel {ratio:.4f}"
                    f" | " + " | ".join(f"{f} {r:.1f}"
                                        for f, r in faults.items())
                    + " (each must exceed 1)")
            del o, lse, o_ref, lse_ref
            ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal,
                                                      window), reps=20)
            lib_ms = time_ms(lambda: sdpa(q, k, v, causal, window), reps=20)
            bound_ms, bound_by = flash_bound(q, k, causal, window)
            err = max(err, e_o)
            log(f"kernel flash_attention {label}: B={b} H={h} Hkv={hkv} "
                f"S={s} D={d} causal={causal} window={window} "
                f"{str(dtype).split('.')[-1]}, variant {variant} "
                f"(variant_launches {variants}) | {check} "
                f"| lse max_abs_err "
                f"{e_l:.3e} (tol {LSE_TOL:.0e}) | kernel {ms:.4f} ms | "
                f"bound {bound_ms:.4f} ms ({bound_by}) | "
                f"{bound_ms / ms:.1%} of bound | sdpa "
                f"{lib_ms:.4f} ms")
            if main is None:
                main = (q, k, v, causal, window, ms, lib_ms, bound_ms,
                        bound_by)
            else:
                del q, k, v
            torch.cuda.empty_cache()
    q, k, v, causal, window, ms, lib_ms, bound_ms, bound_by = main
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal, window),
                       reps=5, warmup=1)
    # the earlier kernel (mma.sync, 64-row tiles) at the same shape
    old_ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal, window,
                                                  variant="mma_sync"),
                     reps=20)
    o, lse = flash_attention_cuda(q, k, v, causal, window)
    do = torch.randn(q.shape, device="cuda").to(q.dtype)
    bwd_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                     causal, window),
                     reps=3, warmup=1)
    log(f"kernel flash_attention timing ({FLASH_CASES[0][0]}, bf16): kernel "
        f"{ms:.4f} ms (wgmma variant) | the mma_sync variant (the earlier "
        f"kernel) {old_ms:.4f} ms | plain {plain_ms:.4f} ms (float32, query "
        f"chunks of 1024) | library {lib_ms:.4f} ms "
        f"(scaled_dot_product_attention, "
        f"is_causal) | bound {bound_ms:.4f} ms ({bound_by}; 989 TFLOP/s bf16 "
        f"H100 SXM data sheet) | plain backward (flash_attention_bwd_ref, "
        f"the train step's) {bwd_ms:.4f} ms")
    del q, k, v, o, lse, do, main
    torch.cuda.empty_cache()

    # gradient: kernel forward + plain backward vs autograd of the plain
    ins = flash_case(2, 8, 2, 512, 64, torch.float32, seed + 600)
    g_out = torch.randn(ins[0].shape, device="cuda")
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = (ops.flash_attention(*leaves, causal=True, window=None)
               if route == "kernel"
               else flash_attention_ref(*leaves, True, None)[0])
        grads[route] = torch.autograd.grad(out, leaves, g_out)
    g_err = max(_rel_err(a, b) for a, b in zip(grads["kernel"],
                                               grads["plain"]))
    assert g_err < 1e-4, g_err
    log(f"flash_attention gradient (FlashAttentionFn: kernel forward, plain "
        f"backward) vs autograd of the plain version, B=2 H=8 Hkv=2 S=512 "
        f"D=64 float32: max over q, k, v of err / max|plain| {g_err:.3e} "
        f"(tol 1e-4)")

    # the same in bf16 through the wgmma forward, which the bf16 train step
    # runs: FlashAttentionFn against the plain backward fed the plain
    # forward's o and lse.  The routes differ only in o (each element within
    # 1.5 bf16 ulps) and lse (LSE_TOL), and each rounds its gradients to
    # bf16: 4 bf16 ulps of the largest gradient
    ins = flash_case(2, 8, 2, 512, 64, torch.bfloat16, seed + 601)
    g_out = torch.randn(ins[0].shape, device="cuda").to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    got = torch.autograd.grad(
        ops.flash_attention(*leaves, causal=True, window=None), leaves, g_out)
    assert ops.variant_launch_counts()["flash_attention"] == {
        "simt_f32": 0, "mma_sync": 0, "wgmma": 1}
    o_ref, lse_ref = flash_attention_ref(*ins, True, None)
    want = flash_attention_bwd_ref(*ins, o_ref, lse_ref, g_out, True, None)
    g16_err = max(_rel_err(a, b.to(torch.bfloat16))
                  for a, b in zip(got, want))
    assert g16_err <= BF16_GRAD_TOL, g16_err
    log(f"flash_attention gradient in bf16 (FlashAttentionFn: wgmma forward, "
        f"plain backward) vs the plain backward from the plain forward's o "
        f"and lse, B=2 H=8 Hkv=2 S=512 D=64: max over q, k, v of err / "
        f"max|plain| {g16_err:.3e} (tol {BF16_GRAD_TOL:.3e}: 4 bf16 ulps)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:116",
            "variant": "wgmma", "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


# ------------------------- dense train phase --------------------------- #
def dense_train_phase(seed: int, rows: dict) -> None:
    cfg = with_layer_units(get_config(DENSE_ARCH), DENSE_TRAIN["layers"])
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"dense train {cfg.name}: {cfg.num_layers} of 40 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"{cfg.param_count() / 1e9:.3f}B params, random weights (seed "
        f"{seed}) and AdamW state in {time.perf_counter() - t0:.1f} s")
    steps = DENSE_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=DENSE_TRAIN["lr"],
                          warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="wsd")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, DENSE_TRAIN["batch"], DENSE_TRAIN["seq"], i)
               for i in range(steps + 1)]
    tokens = DENSE_TRAIN["batch"] * DENSE_TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        walls.append(wall)
        log(f"dense train step {i}: loss {loss:.4f} | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | lr {metrics['lr']:.2e} | "
            f"wall {wall * 1e3:.1f} ms | {tokens / wall:.1f} tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = 2 * cfg.num_layers * steps
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": want["flash_attention"]}, variants
    rows["flash_attention"]["launches"] = counts["flash_attention"]
    steady = float(np.median(walls[1:]))
    log(f"dense train: {steps} steps of {DENSE_TRAIN['batch']} x "
        f"{DENSE_TRAIN['seq']} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} | step wall median of steps 1-{steps - 1} "
        f"{steady * 1e3:.1f} ms (step 0 {walls[0] * 1e3:.1f} ms) = "
        f"{tokens / steady:.1f} tok/s | max_memory_allocated {peak_gb:.3f} GB")
    log(f"dense train: flash_attention launches per step "
        f"{counts['flash_attention'] // steps} (2 x {cfg.num_layers} layers: "
        f"forward and remat), every one the wgmma variant")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one dense train step (kernel route): "
        f"{profile_step(one_step)}")


def dense_lr_witness(seed: int) -> None:
    """Whether the dense train phase's loss rise at a learning rate of
    WITNESS_LR comes from the flash kernel: the same steps through the
    kernel route and through the plain chunked route (use_kernel=False:
    no kernel at all), from the same weights and batches."""
    cfg = with_layer_units(get_config(DENSE_ARCH), DENSE_TRAIN["layers"])
    steps = DENSE_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=WITNESS_LR, warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="wsd")
    batches = [lm_batch(cfg, DENSE_TRAIN["batch"], DENSE_TRAIN["seq"], i)
               for i in range(steps)]
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
        step_fn = make_train_step(cfg, opt_cfg, use_kernel=use_kernel)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, walls = [], [], []
        for batch in batches:
            state, metrics, loss, wall = timed_step(step_fn, state, batch)
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            walls.append(wall)
        log(f"lr witness, {'kernel' if use_kernel else 'plain'} route, "
            f"{cfg.num_layers} layers, lr {WITNESS_LR:.0e} (wsd): loss "
            + " ".join(f"{x:.4f}" for x in losses) + " | grad_norm "
            + " ".join(f"{x:.3f}" for x in norms) + f" | step wall median "
            f"{float(np.median(walls)) * 1e3:.1f} ms | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del state, step_fn
        torch.cuda.empty_cache()


def dense_route_phase(seed: int, arch: str = DENSE_ARCH) -> None:
    """One train step of a float32 2-layer ``arch`` at full width through
    the flash kernel (the simt_f32 variant: float32) and through the plain
    chunked attention, from the same weights and batch; first the
    gradients themselves.  The kernel route's gradients and updated
    params stay on the card; the plain route's are compared as they come
    and then freed (mistral-nemo-12b's 2 layers hold 1.9 B float32
    params)."""
    cfg = dataclasses.replace(
        with_layer_units(get_config(arch), DENSE_ROUTE["layers"]),
        dtype="float32")
    opt_cfg = AdamWConfig(lr=DENSE_ROUTE["lr"], warmup_steps=1,
                          total_steps=5, schedule="wsd")
    batch = lm_batch(cfg, DENSE_ROUTE["batch"], DENSE_ROUTE["seq"], 0)
    out, launches = {}, {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
        _, _, grads = value_and_grad(state.params, cfg, batch,
                                     use_kernel=use_kernel)
        grads = tree_leaves(grads)
        if use_kernel:
            kept = grads
        else:
            d_grad = max(_rel_err(a, b) for a, b in zip(kept, grads))
            del kept
        del grads
        step_fn = make_train_step(cfg, opt_cfg, use_kernel=use_kernel)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, metrics, loss, wall = timed_step(step_fn, state, batch)
        counts = ops.launch_counts()
        variants = ops.variant_launch_counts()["flash_attention"]
        want = dict.fromkeys(ops.WRAPPERS, 0)
        want_variants = dict.fromkeys(variants, 0)
        if use_kernel:
            want["flash_attention"] = 2 * cfg.num_layers
            want_variants["simt_f32"] = 2 * cfg.num_layers
            launches = variants
        assert counts == want, (arch, counts, want)
        assert variants == want_variants, (arch, variants, want_variants)
        params = tree_leaves(state.params)
        if use_kernel:
            kept_params = params
        else:
            d_param = max(float((a - b).abs().max())
                          for a, b in zip(kept_params, params))
        out[use_kernel] = (loss, float(metrics["grad_norm"]))
        log(f"dense route {arch} {'kernel' if use_kernel else 'plain '}: "
            f"loss {loss:.6f} | grad_norm {out[use_kernel][1]:.6f} | step "
            f"wall {wall * 1e3:.1f} ms | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del state, step_fn, params, metrics
        torch.cuda.empty_cache()
    del kept_params
    torch.cuda.empty_cache()
    (lk, nk), (lp, n_p) = out[True], out[False]
    d_loss = abs(lk - lp) / abs(lp)
    d_gnorm = abs(nk - n_p) / abs(n_p)
    # float32 throughout: the kernel and the chunked path sum the softmax
    # in other orders (and the backward is the flash recomputation vs
    # autograd of the chunk steps), ~1e-6 relative; the same bounds as
    # the scan's route check
    assert d_loss < 1e-4 and d_gnorm < 1e-4 and d_grad < 1e-4 \
        and d_param < 1e-5, (arch, d_loss, d_gnorm, d_grad, d_param)
    log(f"dense route {arch} kernel vs plain ({cfg.num_layers} layers, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, float32, {DENSE_ROUTE['batch']} x "
        f"{DENSE_ROUTE['seq']}): flash_attention launches in the kernel "
        f"step {launches} | loss rel diff {d_loss:.3e} (tol 1e-4) | "
        f"grad_norm rel diff {d_gnorm:.3e} (tol 1e-4) | gradients, max over "
        f"leaves of err / max|plain| {d_grad:.3e} (tol 1e-4) | params "
        f"after the update max abs diff {d_param:.3e} (tol 1e-5)")


def dense_decode_phase(seed: int) -> None:
    """Prompts through ``prefill`` at full depth (the flash kernel in every
    layer), the cache padded by 8 positions, then greedy decode steps,
    each held against the teacher-forced forward."""
    cfg = get_config(DENSE_ARCH)
    params = init_params(cfg, seed=seed, device="cuda")
    b, n_prompt = DENSE_DECODE["batch"], DENSE_DECODE["prompt"]
    prompt = lm_batch(cfg, b, n_prompt, 1)["tokens"]
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = cfg.num_layers
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": cfg.num_layers}, variants
    pad = (0, 0, 0, 0, 0, DENSE_DECODE["headroom"])
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                 v=torch.nn.functional.pad(cache["v"], pad))
    steps, toks = [logits], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(DENSE_DECODE["new_tokens"]):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = decode_step(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    del cache
    # teacher forcing over prompt + generated tokens, filled up to a whole
    # KV chunk (the chunked branch needs S % 1024 == 0); causal, so the
    # filler changes no position before it
    seq = torch.cat([prompt] + toks, dim=1)
    fill = -seq.shape[1] % 1024
    seq = torch.nn.functional.pad(seq, (0, fill))
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": seq})
    got = torch.cat(steps, dim=1)
    want_logits = full[:, n_prompt - 1:n_prompt + DENSE_DECODE["new_tokens"]]
    del full
    err = float((got - want_logits).abs().max())
    # bf16 model: both sides round every GEMM output and the logits to
    # bf16, in GEMMs of other shapes (M = 2 per decode step vs 2 x 5120);
    # held to two bf16 ulps of the largest logit (ROADMAP C5's floor is
    # one)
    tol = 2 * float(bf16_ulp(want_logits.abs().max()))
    assert torch.isfinite(got).all() and err <= tol, (err, tol)
    log(f"dense prefill + decode ({cfg.num_layers} layers, {cfg.dtype}): "
        f"prefill {b} x {n_prompt} tokens in {t_prefill * 1e3:.1f} ms "
        f"(flash_attention launches {counts['flash_attention']}, one per "
        f"layer, all wgmma) | cache padded by {DENSE_DECODE['headroom']} | "
        f"{DENSE_DECODE['new_tokens']} greedy decode steps in "
        f"{t_decode * 1e3:.1f} ms (no kernel: direct attention over the "
        f"cache, as in the reference) | logits vs teacher-forced forward "
        f"max_abs_err {err:.3e} (tol {tol:.3e}: 2 bf16 ulps of the largest "
        f"logit)")


# ---------------------- multi_add and matmul_tiled --------------------- #
def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-30))


def collective_kernel_phase(seed: int) -> list:
    """Rows 2-3 of the kernel table: ``multi_add`` and ``matmul_tiled``
    against their plain versions on the card, then timed at their first
    shape beside the bound, the plain version and one PyTorch call."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 400)
    ma_err, ma_main = 0.0, None
    for label, k, n, dtype in MULTI_ADD_CASES:
        x = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        got = ops.multi_add(x)
        torch.cuda.synchronize()
        want = multi_add_ref(x)
        # the kernel adds rows 0..K-1 in order in float32, as the plain
        # version does, and rounds once: bitwise equal
        assert torch.equal(got, want), (label, _rel_err(got, want))
        ma_err = max(ma_err, float((got.float() - want.float()).abs().max()))
        ms = time_ms(lambda: ops.multi_add(x))
        bound_ms = (k + 1) * n * x.element_size() / HBM_BYTES_PER_S * 1e3
        log(f"kernel multi_add {label}: K={k} N={n} "
            f"{str(dtype).split('.')[-1]} | bitwise equal to the plain "
            f"version | kernel {ms:.4f} ms | bound {bound_ms:.4f} ms "
            f"(bytes) | {bound_ms / ms:.1%} of bound")
        if ma_main is None:
            ma_main = (x, ms, bound_ms)
    x, ms, bound_ms = ma_main
    ma_row = {"name": "multi_add", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/multi_add.cu",
              "replaces": "src/repro/kernels/multi_add.py:44",
              "launches": None, "max_abs_err": ma_err, "ms": ms,
              "plain_ms": time_ms(lambda: multi_add_ref(x)),
              "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": time_ms(lambda: torch.sum(
                  x, 0, dtype=torch.float32).to(x.dtype))}
    log(f"kernel multi_add timing ({MULTI_ADD_CASES[0][0]}): kernel {ms:.4f} "
        f"ms | plain {ma_row['plain_ms']:.4f} ms (K-1 elementwise adds) | "
        f"library {ma_row['library_ms']:.4f} ms (torch.sum over K in "
        f"float32, cast back) | bound {bound_ms:.4f} ms")
    del x, ma_main

    mm_err, mm_main = 0.0, None
    for label, m, k, n, dtype in MATMUL_CASES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(dtype)
        variant = matmul_variant(dtype, k, n, x.data_ptr(), w.data_ptr())
        ops.reset_launch_counts()
        got = ops.matmul_tiled(x, w)
        torch.cuda.synchronize()
        assert ops.variant_launch_counts()["matmul_tiled"][variant] == 1, \
            (label, variant)
        want = matmul_tiled_ref(x, w)
        err = _rel_err(got, want)
        assert err <= MM_TOL[dtype], (label, err)
        mm_err = max(mm_err, float((got.float() - want.float()).abs().max()))
        ms = time_ms(lambda: ops.matmul_tiled(x, w), reps=20)
        t_ops = 2 * m * n * k / PEAK_OPS_PER_S[dtype]
        t_bytes = (m * k + k * n + m * n) * x.element_size() / \
            HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"kernel matmul_tiled {label}: [{m}, {k}] @ [{k}, {n}] "
            f"{str(dtype).split('.')[-1]}, variant {variant} | err / "
            f"max|plain| {err:.3e} (tol "
            f"{MM_TOL[dtype]:.0e}) | kernel {ms:.4f} ms | bound "
            f"{bound_ms:.4f} ms ({bound_by}) | {bound_ms / ms:.1%} of bound "
            f"| {2 * m * n * k / ms / 1e9:.1f} TFLOP/s")
        if dtype == torch.float32:
            log(f"kernel matmul_tiled {label}: library "
                f"{time_ms(lambda: torch.matmul(x, w), reps=20):.4f} ms "
                f"(torch.matmul in float32, TF32 off)")
        if mm_main is None:
            mm_main = (x, w, ms, bound_ms, bound_by)
    x, w, ms, bound_ms, bound_by = mm_main
    # the earlier kernel (WMMA, cp.async) at the same shape
    ms_wmma = time_ms(lambda: matmul_tiled_cuda(x, w, variant="wmma_masked"),
                      reps=20)
    mm_row = {"name": "matmul_tiled", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/matmul_tiled.cu",
              "replaces": "src/repro/kernels/fused_matmul_rs.py:72",
              "variant": "wgmma", "launches": 0, "max_abs_err": mm_err,
              "ms": ms,
              "plain_ms": time_ms(lambda: matmul_tiled_ref(x, w), reps=20),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": time_ms(lambda: torch.matmul(x, w), reps=20)}
    log(f"kernel matmul_tiled timing ({MATMUL_CASES[0][0]}): kernel {ms:.4f} "
        f"ms (wgmma variant, 128 x 256 tiles) | the wmma_masked variant (the "
        f"earlier kernel) "
        f"{ms_wmma:.4f} ms | plain {mm_row['plain_ms']:.4f} ms (float32 "
        f"product, cast) | library {mm_row['library_ms']:.4f} ms (torch.matmul in bf16, "
        f"cuBLAS) | bound {bound_ms:.4f} ms ({bound_by})")
    return [ma_row, mm_row]


# -------------------------- collective phase ---------------------------- #
def collective_inputs(p: int, nbytes: int, dtype, seed: int):
    """Each rank's 1-D input of ``nbytes``: integer-valued float32 in
    [-8, 8] (every order of adds is exact), or normal bfloat16."""
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    n -= n % p                  # reduce_scatter and all_to_all split by P
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if dtype == torch.float32:
        return [torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                              dtype=torch.int32).float() for _ in range(p)]
    return [torch.randn((n,), generator=gen, device="cuda").to(dtype)
            for _ in range(p)]


def collective_expected(op: str, xs, rank: int, root: int = BROADCAST_ROOT):
    """What ``rank`` must hold after ``op`` (None: nothing to check, a
    reduce's non-root ranks keep partials)."""
    p = len(xs)
    if op in ("reduce", "allreduce", "reduce_scatter"):
        if op == "reduce" and rank:
            return None
        total = torch.stack([x.float() for x in xs]).sum(0)
        return total.chunk(p)[rank] if op == "reduce_scatter" else total
    if op == "allgather":
        return torch.cat(xs)
    if op == "broadcast":
        return xs[root]
    return torch.cat([x.chunk(p)[rank] for x in xs])


def check_collective(op: str, got, want) -> float:
    """Bitwise equality for float32 (and for every op that only moves
    bf16 values); for a bf16 sum, its error relative to the exact sum's
    max-abs, which must stay within 5e-2 (one hop's bf16 rounding per add,
    ROADMAP C4)."""
    if got.dtype == torch.float32 or op in ("allgather", "broadcast",
                                            "all_to_all"):
        assert torch.equal(got.float(), want.float()), op
        return 0.0
    err = _rel_err(got, want)
    assert err <= 5e-2, (op, err)
    return err


def run_collective(eng, op: str, alg: str, xs, comm):
    fn = getattr(eng, op + "_inside")
    if op == "broadcast":
        return fn(xs[comm.rank], comm, BROADCAST_ROOT, alg)
    return fn(xs[comm.rank], comm, alg)


def collective_phase(seed: int) -> None:
    eng = get_engine()
    p = COLLECTIVE_RANKS
    t0 = time.perf_counter()
    runs, bf16_err = 0, 0.0
    for nbytes in COLLECTIVE_BYTES:
        for dtype in (torch.float32, torch.bfloat16):
            xs = collective_inputs(p, nbytes, dtype, seed + nbytes)
            for op, algs in ALGORITHMS.items():
                wants = [collective_expected(op, xs, r) for r in range(p)]
                for alg in algs:
                    outs = run_local(
                        lambda c: run_collective(eng, op, alg, xs, c), p)
                    torch.cuda.synchronize()
                    for r in range(p):
                        if wants[r] is not None:
                            bf16_err = max(bf16_err, check_collective(
                                op, outs[r], wants[r]))
                    runs += 1
                    del outs
                del wants
            del xs
            torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"collectives: {runs} runs (6 ops x every algorithm + auto x "
        f"{len(COLLECTIVE_BYTES)} sizes x float32/bf16) on {p} LocalComm "
        f"ranks: float32 bitwise equal to the sum over ranks on every "
        f"checked rank; bf16 sums within {bf16_err:.3e} of the exact sum's "
        f"max-abs (tol 5e-2); {wall:.1f} s of host wall (threads, barriers "
        f"and device copies on one card, not a fabric time)")
    for op in ALGORITHMS:
        for nbytes in COLLECTIVE_BYTES:
            model_bytes = nbytes * p if op == "allgather" else nbytes
            d = eng.select(op, model_bytes, p)
            log(f"auto {op} {nbytes >> 10} KB/rank, P={p}: {d.algorithm}, "
                f"predicted {d.predicted:.1f} model cycles (priced on the "
                f"reference's TPU v5e ICI fabric model, TPU_V5E_AXIS; not an "
                f"H100 number)")
    log(f"engine stats: {eng.stats_snapshot()} (ranks share the engine: "
        f"one miss and {p - 1} hits per auto call)")
    xs = collective_inputs(p, 4 << 20, torch.float32, seed)
    prof = profile_step(lambda: run_local(
        lambda c: eng.allreduce_inside(xs[c.rank], c), p))
    log(f"profile of one auto allreduce of 4 MB/rank on {p} local ranks: "
        f"{prof}")


# -------------------------- fused ring phase ---------------------------- #
def fused_inputs(cfg, seed: int):
    """Each TP rank's activations [tokens, d_ff / TP] (normal) and weight
    shard [d_ff / TP, d_model] (normal / sqrt(d_ff)), bf16."""
    tp = FUSED["tp"]
    tokens = FUSED["batch"] * FUSED["seq"]
    k_loc = cfg.d_ff // tp
    xs, ws = [], []
    for r in range(tp):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed * 1000 + r)
        xs.append(torch.randn((tokens, k_loc), generator=gen,
                              device="cuda").to(torch.bfloat16))
        ws.append((torch.randn((k_loc, cfg.d_model), generator=gen,
                               device="cuda") / math.sqrt(cfg.d_ff))
                  .to(torch.bfloat16))
    return xs, ws


def fused_phase(seed: int, rows: dict) -> None:
    cfg = get_config(FUSED_ARCH)
    tp = FUSED["tp"]
    xs, ws = fused_inputs(cfg, seed)
    m, k_loc = xs[0].shape
    n = ws[0].shape[1]
    gb = sum(t.numel() * t.element_size() for t in xs + ws) / 1e9
    eng = get_engine()
    price = eng.price_fused_matmul_rs(m, k_loc, n, tp, dtype_bytes=2)
    log(f"fused {cfg.name} TP-{tp} down-projection: per rank x [{m}, "
        f"{k_loc}] @ w [{k_loc}, {n}] bf16 -> [{m // tp}, {n}]; {gb:.3f} GB "
        f"of operands | auto would take the "
        f"{'fused ring' if price['saved'] > 0 else 'gathered path'} (model "
        f"on the reference's TPU fabric: fused {price['fused']:.0f}, serial "
        f"{price['serial']:.0f} cycles)")
    run_local(lambda c: eng.fused_matmul_reduce_scatter(   # warm-up
        xs[c.rank][:tp * 16], ws[c.rank], c, algorithm="fused"), tp)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_local(lambda c: eng.fused_matmul_reduce_scatter(
        xs[c.rank], ws[c.rank], c, algorithm="fused"), tp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_counts = dict.fromkeys(ops.WRAPPERS, 0)
    want_counts["matmul_tiled"] = tp * tp
    assert counts == want_counts, (counts, want_counts)
    variants = ops.variant_launch_counts()["matmul_tiled"]
    assert variants == {"simt_f32": 0, "wmma_masked": 0,
                        "wgmma": tp * tp}, variants
    rows["matmul_tiled"]["launches"] = counts["matmul_tiled"]
    # multi_add is on no path of the port, as on none of the reference's
    # (only repro/kernels/ops.py and its tests call it): its row reads 0
    rows["multi_add"]["launches"] = counts["multi_add"]

    gathered = run_local(
        lambda c: impl.matmul_then_rs(xs[c.rank], ws[c.rank], c), tp)
    torch.cuda.synchronize()
    errs = []
    for r in range(tp):
        assert got[r].shape == (m // tp, n) and got[r].dtype == torch.bfloat16
        assert torch.isfinite(got[r].float()).all()
        errs.append(_rel_err(got[r], gathered[r]))
    rows_s = slice(0, min(64, m // tp))     # rank 0's block: its first rows
    exact = sum(xs[r][rows_s].double() @ ws[r].double() for r in range(tp))
    err64 = _rel_err(got[0][rows_s], exact)
    assert max(errs) <= FUSED_TOL and err64 <= FUSED_TOL, (errs, err64)
    log(f"fused ring on {tp} LocalComm ranks: {counts['matmul_tiled']} "
        f"matmul_tiled launches ({tp} per rank, all wgmma) | per-rank block "
        f"vs the "
        f"gathered path (float32 GEMM + reduce-scatter), err / max-abs: max "
        f"{max(errs):.3e} | rank 0 rows 0-{rows_s.stop - 1} vs float64: "
        f"{err64:.3e} (tol "
        f"{FUSED_TOL:.4f}: 16 bf16 roundings) | host wall {wall * 1e3:.1f} ms "
        f"(threads on one card, not a fabric time)")
    del gathered, got
    prof = profile_step(lambda: run_local(
        lambda c: eng.fused_matmul_reduce_scatter(
            xs[c.rank], ws[c.rank], c, algorithm="fused"), tp))
    log(f"profile of one fused ring call on {tp} local ranks: {prof}")

    # one backward through the kernel at one ring step's shape
    x = xs[0][: m // tp].clone().requires_grad_()
    w = ws[0].clone().requires_grad_()
    g = torch.randn((m // tp, n), device="cuda").to(torch.bfloat16)
    out = ops.matmul_tiled(x, w)
    out.backward(g)
    torch.cuda.synchronize()
    dx = torch.matmul(g.float(), ws[0].float().t()).to(torch.bfloat16)
    dw = torch.matmul(xs[0][: m // tp].float().t(), g.float()).to(
        torch.bfloat16)
    fwd_err = _rel_err(out.detach(), matmul_tiled_ref(x.detach(), w.detach()))
    assert fwd_err <= MM_TOL[torch.bfloat16], fwd_err
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    log(f"matmul_tiled backward at one ring step ([{m // tp}, {k_loc}] @ "
        f"[{k_loc}, {n}] bf16): forward err / max|plain| {fwd_err:.3e}; dx, "
        f"dw bitwise equal to torch.matmul in float32 (the reference's dense "
        f"backward)")


# ------------------------------ NCCL phase ------------------------------ #
def nccl_worker(rank: int, world: int, init: str, seed: int) -> int:
    """One rank of the NCCL phase, on card ``rank``: the float32
    collective checks and one fused ring at the fused phase's shape."""
    torch.distributed.init_process_group("nccl", init_method=init,
                                         rank=rank, world_size=world)
    comm = ProcessGroupComm(device=f"cuda:{rank}")
    eng = CollectiveEngine(device=comm.device, persist=False)
    checks = 0
    for nbytes in COLLECTIVE_BYTES:
        with torch.cuda.device(comm.device):
            xs = collective_inputs(world, nbytes, torch.float32,
                                   seed + nbytes)
        for op, algs in ALGORITHMS.items():
            want = collective_expected(op, xs, rank)
            for alg in algs:
                if alg in ("tree", "doubling") and world & (world - 1):
                    continue
                got = run_collective(eng, op, alg, xs, comm)
                if want is not None:
                    check_collective(op, got, want)
                    checks += 1
    cfg = get_config(FUSED_ARCH)
    with torch.cuda.device(comm.device):
        xs, ws = fused_inputs(cfg, seed)
    got = impl.fused_matmul_rs(xs[rank], ws[rank], comm)
    gathered = impl.matmul_then_rs(xs[rank], ws[rank], comm)
    err = _rel_err(got, gathered)
    assert err <= FUSED_TOL, err
    torch.cuda.synchronize(comm.device)
    torch.distributed.destroy_process_group()
    print(f"nccl rank {rank}/{world}: {checks} float32 collective checks "
          f"exact; fused ring vs gathered path err / max-abs {err:.3e}",
          flush=True)
    return 0


def nccl_phase(seed: int) -> None:
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"nccl phase: not run ({cards} card)")
        return
    world = 1 << (cards.bit_length() - 1)   # a power of two (tree, doubling)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    init = build.BUILD_DIR / f"nccl_rendezvous_{os.getpid()}"
    init.unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--seed", str(seed), "--nccl-worker",
         str(r), str(world), f"file://{init}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        init.unlink(missing_ok=True)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"nccl rank {r} failed:\n{out[-4000:]}"
        for line in out.splitlines():
            if line.startswith("nccl rank"):
                log(line)
    log(f"nccl phase: {world} ProcessGroupComm ranks, one per card, passed "
        f"in {time.perf_counter() - t0:.1f} s of host wall")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nccl-worker", nargs=3, metavar=("RANK", "WORLD",
                                                       "INIT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--lr-witness", action="store_true",
                    help="run only the dense train steps at lr 1e-3 "
                    "through the kernel and the plain attention route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    if args.nccl_worker:
        rank, world, init = args.nccl_worker
        return nccl_worker(int(rank), int(world), init, args.seed)
    card = nvidia_smi()
    log(f"gpu: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    if args.lr_witness:
        dense_lr_witness(args.seed)
        return 0
    for res in built.values():
        entry = "?"
        for line in res.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"ptxas {res.name} {entry}: {line.strip()}")
    rows = {r["name"]: r for r in [kernel_phase(args.seed),
                                   *collective_kernel_phase(args.seed),
                                   flash_kernel_phase(args.seed),
                                   *scan_kernel_phase(args.seed)]}
    torch.cuda.empty_cache()
    serve_phase(args.seed, rows["paged_attention"])
    torch.cuda.empty_cache()
    train_phase(args.seed, rows)
    torch.cuda.empty_cache()
    route_phase(args.seed)
    decode_phase(args.seed, rows)
    torch.cuda.empty_cache()
    dense_train_phase(args.seed, rows)
    torch.cuda.empty_cache()
    dense_route_phase(args.seed)
    torch.cuda.empty_cache()
    for arch in C12_ARCHS:
        dense_route_phase(args.seed, arch)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    dense_decode_phase(args.seed)
    torch.cuda.empty_cache()
    collective_phase(args.seed)
    torch.cuda.empty_cache()
    fused_phase(args.seed, rows)
    torch.cuda.empty_cache()
    nccl_phase(args.seed)
    for r in rows.values():
        assert r["launches"] > 0 or r["name"] == "multi_add", \
            f"{r['name']} never ran on its path"
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
