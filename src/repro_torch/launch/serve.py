"""Serving CLI of the port: a thin driver over ``repro_torch.serving``
(paged KV cache + continuous batching), on CUDA by default.

    python -m repro_torch.launch.serve --arch minicpm-2b --full-width

serves the architecture at its published width with random weights;
without ``--full-width`` it serves the ``.reduced()`` variant, as the
reference CLI always does.  The flags are those of the reference CLI's
single-server path, plus ``--device`` and ``--full-width``.  A vision
config (``--arch llava-next-34b``) gives each request
``frontend_tokens`` soft tokens from ``models.frontend.vision_patches``,
drawn from a generator seeded with the request id; they lead its
context, so ``max_len`` adds them.

``--dp`` stripes the slot rows over a 1-D ("data",) grid of every rank
of the ``torch.distributed`` world and assembles the sampled tokens
through the CollectiveEngine's allgather, as the reference does over
every device.  Under ``torch.distributed.run`` (torchrun) that is one
process a rank, NCCL on CUDA (each process on the card its
``LOCAL_RANK`` names) and gloo with ``--device cpu``:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --dp --device cpu

Without torchrun the world is this process alone.  The greedy streams
are identical with and without ``--dp``.  ``--trace PATH``,
``--obs-report`` and ``--metrics-out PATH`` (``repro_torch.obs.cli``)
trace the engine's collectives (the DP token assembly), print the
model-error table and dump the metrics registry with the serving
telemetry, as the reference does; under torchrun each process writes its
own files.

With ``--replicas N`` (or any other fleet flag) the CLI stands up
``serving.fleet.FleetServer``: N replicas sharing one set of weights,
behind admission control (``--queue-cap``, ``--tenant-rate``,
``--tenant-burst``; each request's tenant is its shared prompt's index)
and a router (``--router``), stepped in lockstep waves, the arrivals
wave-stamped by ``--arrival`` / ``--arrival-rate``.  Greedy streams are
bitwise those of one server at any fleet size:

    python -m repro_torch.launch.serve --device cpu --shared-prompts 2 \
        --replicas 2 --router prefix_affinity --arrival bursty

With ``--dp`` every replica is striped over the grid, as the reference's
mesh stripes it.  The metrics registry then holds the fleet's gauges
(``serving.fleet.export_fleet_stats``) and no single-server snapshot.
"""

from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.collectives.comm import ProcessGroupGrid, single_rank_grid
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.frontend import vision_patches
from repro_torch.models.paged import PAGED_FAMILIES
from repro_torch.obs import cli as obs_cli
from repro_torch.serving import (ContinuousBatchingServer, Request,
                                 SamplingParams)
from repro_torch.serving.fleet import ARRIVAL_MODES, ROUTER_POLICIES
from repro_torch.serving.telemetry import ttft_low_confidence


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="content-addressed CoW sharing of prompt-prefix "
                         "KV blocks across requests")
    ap.add_argument("--shared-prompts", type=int, default=0, metavar="K",
                    help="draw each request's prompt prefix from K shared "
                         "system prompts (0 = fully distinct prompts)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published widths instead of the "
                         ".reduced() variant")
    ap.add_argument("--dp", action="store_true",
                    help="stripe the slot rows over every rank of the "
                         "torch.distributed world (torchrun) and route "
                         "token sync through the CollectiveEngine")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="serve behind a fleet of N replicas in "
                         "lockstep waves (1 = single server)")
    ap.add_argument("--router", default="round_robin",
                    choices=ROUTER_POLICIES,
                    help="fleet routing policy (used when --replicas "
                         "> 1 or other fleet flags are set)")
    ap.add_argument("--queue-cap", type=int, default=None, metavar="Q",
                    help="fleet-wide queued-request cap; arrivals above "
                         "the cap are rejected with a retry-after hint")
    ap.add_argument("--tenant-rate", type=float, default=None,
                    metavar="TOK",
                    help="per-tenant token-bucket refill "
                         "(prompt+output tokens per wave)")
    ap.add_argument("--tenant-burst", type=float, default=None,
                    metavar="TOK",
                    help="per-tenant bucket capacity (default 8x rate)")
    ap.add_argument("--arrival", default="fixed", choices=ARRIVAL_MODES,
                    help="arrival process for the request trace "
                         "(bursty = Markov-modulated Poisson)")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean arrivals per wave in the calm state")
    obs_cli.add_obs_args(ap)
    return ap.parse_args(argv)


def make_serve_grid(device=None):
    """The 1-D ("data",) grid over every rank of the ``torch.distributed``
    world (joined here under torchrun: ``launch.train.init_world``), or
    over this process alone."""
    from repro_torch.launch.train import init_world
    dev = init_world(device)
    if not dist.is_initialized():
        return single_rank_grid(("data",), dev)
    return ProcessGroupGrid((dist.get_world_size(),), ("data",), device=dev)


def streams_digest(results) -> str:
    """A short digest of every request's tokens, in request order."""
    text = ";".join(f"{rid}:{','.join(map(str, results[rid]))}"
                    for rid in sorted(results))
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def main(argv=None):
    """Serve the requests; returns {rid: generated tokens}."""
    args = parse_args(argv)
    obs_cli.begin(args.trace, args.obs_report, args.metrics_out)
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    if cfg.family not in PAGED_FAMILIES:
        # the reference's own refusal (repro/launch/serve.py)
        raise SystemExit(
            f"--arch {args.arch} (family {cfg.family!r}) is not servable: "
            f"the paged KV cache covers the dense and MoE decoder families "
            f"(constant-state families keep the dense training cache)")
    grid, batch, owns_world = None, args.batch, False
    if args.dp:
        owns_world = not dist.is_initialized()
        grid = make_serve_grid(args.device)
        ndev = grid.axis_size("data")
        if batch % ndev:
            batch += -batch % ndev
            print(f"[serve] rounding batch to {batch} "
                  f"(dp axis = {ndev} ranks)")
    device = grid.device if grid is not None else args.device
    try:
        return _serve(args, cfg, grid, batch, device)
    finally:
        if owns_world and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, cfg, grid, batch, device):
    lead = grid is None or grid.rank == 0
    params = init_params(cfg, seed=0, device=device)
    max_len = (args.prompt_len + args.new_tokens + cfg.frontend_tokens
               + args.block_size)
    fleet_mode = (args.replicas > 1 or args.arrival != "fixed"
                  or args.queue_cap is not None
                  or args.tenant_rate is not None)
    rng = np.random.default_rng(0)
    shared = [rng.integers(0, cfg.vocab_size,
                           size=max(args.prompt_len - 4, 1)).astype(np.int32)
              for _ in range(args.shared_prompts)]

    def make_request(rid):
        soft = None
        if cfg.frontend == "vision":
            gen = torch.Generator(device=device)
            gen.manual_seed(rid)
            soft = vision_patches(gen, cfg, 1, device)
        tenant = "solo"
        if shared:
            # shared system prompt + short per-request suffix
            tenant = f"tenant-{rid % len(shared)}"
            prompt = np.concatenate(
                [shared[rid % len(shared)],
                 rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)])
        else:
            prompt = rng.integers(0, cfg.vocab_size,
                                  size=args.prompt_len).astype(np.int32)
        return tenant, Request(
            rid=rid, prompt=prompt, max_new_tokens=args.new_tokens,
            sampling=SamplingParams(temperature=args.temperature),
            soft_emb=soft)

    kw = dict(grid=grid, device=device, block_size=args.block_size,
              prefill_chunk=args.prefill_chunk, top_k=args.top_k,
              prefix_cache=args.prefix_cache)
    if fleet_mode:
        results = _run_fleet(args, cfg, params, batch, max_len, kw,
                             make_request, lead)
        snap = None
    else:
        results, snap = _run_server(args, cfg, params, batch, max_len, kw,
                                    make_request, lead)
    # every rank, while the world is up: a process grid replays in
    # lockstep; in fleet mode the registry holds the fleet's gauges
    obs_cli.finish(args.trace, args.obs_report, args.metrics_out,
                   grid=grid, device=device, telemetry_snapshot=snap,
                   label="serve")
    if not lead:
        return results
    for rid in sorted(results)[:3]:
        print(f"  req {rid}: {results[rid][:8]}...")
    print(f"[serve] streams digest {streams_digest(results)}")
    return results


def _run_server(args, cfg, params, batch, max_len, kw, make_request, lead):
    """One server: submit every request, serve them, report.  Returns
    (results, its telemetry snapshot)."""
    server = ContinuousBatchingServer(cfg, params, batch, max_len=max_len,
                                      **kw)
    t0 = time.time()
    for rid in range(args.requests):
        server.submit(make_request(rid)[1])
    results = server.run()
    dt = time.time() - t0
    snap = server.snapshot()
    if not lead:
        return results, snap
    if kw["grid"] is not None:
        dec = server.assembly_decision
        print(f"[serve] dp axis 'data' = {kw['grid'].axis_size('data')} "
              f"ranks; token assembly: allgather[{dec.algorithm}] "
              f"({server.assembly_regime} regime, {batch * 4} bytes)")
    total = sum(len(v) for v in results.values())
    print(f"[serve] {cfg.name} on {server.device}: {len(results)} requests, "
          f"{total} tokens in {dt:.1f}s ({total / dt:.1f} tok/s)")
    lc = (f" (low confidence, n={snap.ttft_samples})"
          if ttft_low_confidence(snap) else "")
    print(f"[serve] ttft p50={snap.ttft_p50_ms:.0f}ms "
          f"p99={snap.ttft_p99_ms:.0f}ms{lc} | decode steps "
          f"{snap.decode_steps} | prefill chunks "
          f"{snap.prefill_chunks} | preemptions {snap.preemptions} | "
          f"peak kv occupancy {snap.kv_peak_occupancy:.2f}")
    print(f"[serve] prefix cache: "
          f"{'on' if args.prefix_cache else 'off'} | prefill tokens "
          f"computed {snap.prefill_tokens_computed} | cached "
          f"{snap.cached_prefix_tokens} "
          f"({snap.cached_token_fraction:.0%}) | evictions "
          f"{snap.prefix_evictions} | kv blocks live "
          f"{snap.kv_blocks_live} / evictable "
          f"{snap.kv_blocks_evictable}")
    return results, snap


def _run_fleet(args, cfg, params, batch, max_len, kw, make_request, lead):
    """Fleet path: wave-stamped arrivals -> admission -> router ->
    lockstep replicas (the reference's ``_run_fleet``).  Returns the
    results; the fleet's gauges go to the process registry."""
    from repro_torch.serving.fleet import (AdmissionConfig, FleetServer,
                                           arrival_waves,
                                           export_fleet_stats)
    admission = AdmissionConfig(queue_cap=args.queue_cap,
                                tenant_rate=args.tenant_rate,
                                tenant_burst=args.tenant_burst)
    fleet = FleetServer(cfg, params, args.replicas, batch, max_len,
                        router=args.router, admission=admission, **kw)
    waves = arrival_waves(args.requests, args.arrival,
                          rng=np.random.default_rng(1),
                          rate=args.arrival_rate)
    arrivals = []
    for rid in range(args.requests):
        tenant, req = make_request(rid)
        arrivals.append((waves[rid], tenant, req))
    t0 = time.time()
    results, rejections = fleet.run_trace(arrivals)
    dt = time.time() - t0
    export_fleet_stats(fleet)
    if not lead:
        return results
    snap = fleet.snapshot()
    total = sum(len(v) for v in results.values())
    print(f"[fleet] {cfg.name} on {fleet.replicas[0].server.device}: "
          f"{args.replicas} replicas | router {args.router} | arrival "
          f"{args.arrival} | {len(results)} requests, {total} tokens in "
          f"{dt:.1f}s ({total / dt:.1f} tok/s)")
    print(f"[fleet] waves {snap.waves} | routed {list(snap.routed)} | "
          f"admitted {snap.admitted} | rejected {snap.rejected} "
          f"({dict(snap.rejected_by_reason)}) | below-cap rejects "
          f"{snap.rejected_below_cap}")
    print(f"[fleet] fleet prefill computed "
          f"{snap.prefill_tokens_computed} | cached "
          f"{snap.cached_prefix_tokens} "
          f"({snap.cached_token_fraction:.0%}) | per-replica queue "
          f"depth max {list(snap.queue_depth_max)}")
    for i, rs in enumerate(snap.replicas):
        qw = (f"{rs.queue_wait_p50_ms:.0f}ms"
              if rs.queue_wait_p50_ms is not None else "n/a")
        print(f"[fleet]   replica {i}: decode steps {rs.decode_steps} | "
              f"prefill computed {rs.prefill_tokens_computed} | cached "
              f"{rs.cached_prefix_tokens} | queue wait p50 {qw}")
    if rejections:
        r = rejections[0]
        print(f"[fleet]   first rejection: rid {r.rid} ({r.reason}) "
              f"retry after {r.retry_after_waves} waves")
    return results


if __name__ == "__main__":
    main()
