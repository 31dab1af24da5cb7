#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. environment: the card's name and power limit, torch and CUDA
   versions; every kernel is built from the sources in this checkout
   (``nvcc``, one process per source, all started together);
2. kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at the serving path's shapes and a few more,
   with the stated tolerances, and timed (CUDA events, L2 flushed before
   each launch, median of 30) beside the least time the card could take
   (H100 SXM data-sheet rates);
3. serve phase: ``minicpm-2b`` at its published width (40 layers, bf16,
   random weights from ``--seed``) through ``ContinuousBatchingServer``:
   16 requests over 4 shared system prompts, 64 greedy tokens each.  The
   launch counts show the decode path went through the kernels, and one
   mid-run decode step (its state copied during the run, replayed after
   it) is held against the plain attention path and profiled.

It exits non-zero, printing no result, without a GPU or outside a
checkout of the repository.  The last lines are a JSON line of per-kernel
numbers, the card's name and power limit as ``nvidia-smi`` gives them,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
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
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import paged_attention_ref  # noqa: E402
from repro_torch.models import decode_step_paged, init_params  # noqa: E402
from repro_torch.serving import ContinuousBatchingServer, Request  # noqa

#: NVIDIA H100 SXM data sheet: device memory rate, dense peak rates by the
#: inputs' type (bf16 on the tensor cores, float32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-5}
L2_FLUSH_BYTES = 128 << 20          # twice the 50 MB L2
SPIN_CYCLES = 5_000_000             # a few ms of device spin per launch

SERVE_ARCH = "minicpm-2b"
SERVE = dict(batch=8, requests=16, system_prompts=4, system_len=80,
             suffix=(16, 240), new_tokens=64, block_size=16,
             prefill_chunk=128)


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
    serve_phase(args.seed, row)
    print(json.dumps({"kernels": [row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
