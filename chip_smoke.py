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
   teacher-forced forward.

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
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import with_layer_units  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels.ref import (paged_attention_ref,  # noqa: E402
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
    the card's maximum SM clock)."""
    bsd, bsn, dn, bdn = b * s * d, b * s * n, d * n, b * d * n
    hck = b * -(-s // 64) * d * n
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
    on the card, then timed at one layer of the train phase."""
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    cases = [
        # (label, b, s, d, n, dtype, gradients)
        ("training layer width, S 1024", 2, 1024, 8192, 16, torch.float32,
         True),
        ("ragged: S 100, D 48", 2, 100, 48, 16, torch.float32, True),
        ("bf16 inputs", 2, 512, 1024, 16, torch.bfloat16, False),
    ]
    err = {"fwd": 0.0, "ckpt": 0.0, "bwd": 0.0}
    for i, (label, b, s, d, n, dtype, grads) in enumerate(cases):
        args = scan_case(b, s, d, n, dtype, seed + 100 + i)
        y5, h5 = ss.selective_scan(*args)
        y6, h6, hck = ss.selective_scan_fwd_ckpt(*args)
        torch.cuda.synchronize()
        y_r, h_r = selective_scan_ref(*args)
        torch.cuda.synchronize()
        msg = []
        for kind, y, h in (("fwd", y5, h5), ("ckpt", y6, h6)):
            e = max(float((y.float() - y_r.float()).abs().max()),
                    float((h - h_r).abs().max()))
            assert e <= tol[dtype], (label, kind, e)
            err[kind] = max(err[kind], e)
            msg.append(f"{kind} max_abs_err {e:.3e}")
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
            + f" (tol {tol[dtype]:.0e})")
        del args, y5, h5, y6, h6, hck, y_r, h_r
    torch.cuda.empty_cache()

    b, s, d, n = SCAN_TIMING
    args = scan_case(b, s, d, n, torch.float32, seed)
    _, _, hck = ss.selective_scan_fwd_ckpt(*args)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 300)
    dy = torch.randn((b, s, d), generator=gen, device="cuda")
    dhf = torch.randn((b, d, n), generator=gen, device="cuda")
    ms = {"fwd": time_ms(lambda: ss.selective_scan(*args), reps=20),
          "ckpt": time_ms(lambda: ss.selective_scan_fwd_ckpt(*args),
                          reps=20),
          "bwd": time_ms(lambda: ss.selective_scan_bwd(
              *args[:5], hck, dy, dhf), reps=20)}
    plain_reps = 3
    with torch.no_grad():
        plain_fwd = time_ms(lambda: selective_scan_ref(*args),
                            reps=plain_reps, warmup=1)
    leaves = [t.clone().requires_grad_() for t in args]
    y, hf = selective_scan_ref(*leaves)
    plain_bwd = time_ms(lambda: torch.autograd.grad(
        (y, hf), leaves, (dy, dhf), retain_graph=True), reps=plain_reps,
        warmup=1)
    del y, hf, leaves
    torch.cuda.empty_cache()
    plain = {"fwd": plain_fwd, "ckpt": plain_fwd, "bwd": plain_bwd}
    rows = {}
    names = {"fwd": ("selective_scan", 84), "ckpt":
             ("selective_scan_fwd_ckpt", 221),
             "bwd": ("selective_scan_bwd", 257)}
    plain_note = {"fwd": "", "ckpt": ", forward only, shared with row 5",
                  "bwd": ", autograd backward of the recurrence"}
    for kind, (name, line) in names.items():
        bound_ms, bound_by = scan_bound(kind, b, s, d, n, 4)
        log(f"kernel {name} timing at one train-phase layer (B={b} S={s} "
            f"D={d} N={n} float32): kernel {ms[kind]:.4f} ms (median of "
            f"20) | plain {plain[kind]:.4f} ms (median of {plain_reps}"
            f"{plain_note[kind]}) | bound {bound_ms:.4f} ms ({bound_by}) | "
            f"{bound_ms / ms[kind]:.1%} of bound")
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
    want = {"selective_scan": 0, "paged_attention": 0,
            "selective_scan_fwd_ckpt": 2 * cfg.num_layers * steps,
            "selective_scan_bwd": cfg.num_layers * steps}
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
    want = {"selective_scan": cfg.num_layers, "paged_attention": 0,
            "selective_scan_fwd_ckpt": 0, "selective_scan_bwd": 0}
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    log(f"gpu: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for res in built.values():
        for line in res.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {res.name}: {line.strip()}")
    row = kernel_phase(args.seed)
    rows = {r["name"]: r for r in [row, *scan_kernel_phase(args.seed)]}
    torch.cuda.empty_cache()
    serve_phase(args.seed, row)
    torch.cuda.empty_cache()
    train_phase(args.seed, rows)
    torch.cuda.empty_cache()
    route_phase(args.seed)
    decode_phase(args.seed, rows)
    for r in rows.values():
        assert r["launches"] > 0, f"{r['name']} never ran on its path"
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
