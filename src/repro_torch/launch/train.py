"""Training CLI of the port: data pipeline -> train loop, on CUDA by
default, on one device or data-parallel over a ``torch.distributed``
world.

    python -m repro_torch.launch.train --arch falcon-mamba-7b --reduced \\
        --steps 20 --batch 4 --seq 128 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --reduced \\
        --steps 5 --batch 4 --seq 64 --device cpu
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch minicpm-2b --reduced --dp \\
        --grad-sync fsdp --steps 5 --batch 8 --seq 64 --device cpu

On a GPU the hand-written kernels run: the SSM's scan (forward with
chunk checkpoints, recomputing backward) and the attention over
sequences longer than 2048 of the dense, MoE and hybrid families (the
flash kernel; the hybrid's local blocks at head dim 256 with a 2048
window); on the CPU, which runs only when asked for with ``--device
cpu``, their plain chunked versions.  ``minicpm-2b`` trains with the WSD schedule, every
other architecture with cosine, as in the reference.  The weights are
random from seed 0, as the reference's.

``--dp`` runs one process per rank under ``torch.distributed.run``
(torchrun): NCCL on CUDA, each process on the card its ``LOCAL_RANK``
names, gloo with ``--device cpu``.  The world is the reference's
``(pod, data)`` mesh (two pods when four or more ranks split evenly);
each rank trains on its rows of the global batch and the gradients sync
through the paper's collectives (``--grad-sync allreduce | fsdp``,
``--fused`` for the engine's fused reduce-scatter, ``--fabric`` for
per-axis link constants).  Outside torchrun the world is this one
process and the sync has no axis, as the reference on one device.

Every family trains here (``--arch recurrentgemma-9b --reduced --device
cpu``: RG-LRU blocks and local attention; ``--arch whisper-medium``: the
encoder-decoder).  Each step's batch comes from :func:`build_batch`, as
the reference's: the encoder-decoder's audio frames and a vision
config's soft tokens from the stub frontends (``models/frontend.py``),
drawn from a generator seeded with (seed, step).  ``--experts N`` overrides
the expert count; ``--moe-ep [ALG]`` routes the MoE dispatch and combine
through explicit all-to-all exchanges over the DP grid's expert axes
(``models/moe_ep.py``; ``lax``: the communicator's native exchange,
else an engine algorithm or plan shape, default ``auto``):

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch olmoe-1b-7b --reduced --dp \
        --moe-ep --steps 2 --batch 4 --seq 64 --device cpu

Without ``--dp`` (no grid) ``--moe-ep`` falls back, loudly, as the
reference does.

``--trace PATH``, ``--obs-report`` and ``--metrics-out PATH``
(``repro_torch.obs.cli``) trace every engine collective of the run
(each span measured: the device is synchronised after the call), then
write the Chrome trace, print the model-error table and dump the
metrics registry; under torchrun each process writes its own files,
its rank before the extension.

``--ckpt-dir D`` checkpoints the train state every ``--ckpt-every`` steps
(default 50) and at the end, asynchronously, keeping the newest two
(``repro_torch.checkpoint``, the reference's file format), and resumes
from the newest committed step when ``D`` holds one: the loop starts
there, and since every batch depends only on (seed, step) the resumed
run sees the batches of an uninterrupted one.  A SIGTERM
(``runtime.PreemptionGuard``) ends the run after the step in flight,
which is saved as step ``k + 1``; the final save of step ``steps`` comes
only when the loop ran to its end.  (The reference saves the preempted
state a second time as step ``steps`` (ROADMAP.md C29), so its resume
runs nothing: the port does not.)

    python -m repro_torch.launch.train --arch minicpm-2b --reduced \
        --steps 30 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt --ckpt-every 10 \
        --device cpu

Under ``--dp`` with ``--grad-sync allreduce`` every rank holds the whole
state: rank 0 writes ``shard_0.npz`` and ``COMMIT`` after a barrier and
every rank restores ``shard_0``.  Under ``--grad-sync fsdp`` each rank
holds its own flat shard of the moments (``train.step.fsdp_sync_apply``),
so each writes and restores ``shard_<rank>``, and rank 0 writes its shard
and ``COMMIT`` after a barrier that follows the others' writes.  A
SIGTERM to any rank stops every rank after the same step.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import signal
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.collectives.comm import (GridComm, ProcessGroupGrid,
                                          single_rank_grid)
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.models.frontend import audio_frames, vision_patches
from repro_torch.models.layers import ambient_grid, set_fused_tp
from repro_torch.obs import cli as obs_cli
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.runtime import PreemptionGuard, StragglerDetector
from repro_torch.sharding.rules import grad_sync_axes_for_grid
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.step import (GradSyncConfig, fsdp_layout,
                                   make_train_step)

DP_AXES = ("pod", "data")


def init_world(device: DeviceLike = None) -> torch.device:
    """This process's device, after joining the ``torch.distributed``
    world when torchrun started it (``WORLD_SIZE`` set): NCCL on CUDA
    (this process on card ``LOCAL_RANK``), gloo on the CPU, initialised
    from torchrun's environment."""
    dev = resolve_device(device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    if dist.is_initialized() and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_dp_grid(device: DeviceLike = None) -> GridComm:
    """The (pod, data) grid over every rank of the ``torch.distributed``
    world, the reference's ``make_dp_mesh`` rule: two pods when the
    world has four or more ranks and splits evenly, one otherwise.  Under
    torchrun the world is initialised here (:func:`init_world`); without
    it the world is this process alone."""
    dev = init_world(device)
    if not dist.is_initialized():
        return single_rank_grid(DP_AXES, dev)
    world = dist.get_world_size()
    pod = 2 if world >= 4 and world % 2 == 0 else 1
    return ProcessGroupGrid((pod, world // pod), DP_AXES, device=dev)


def step_generator(seed: int, step: int,
                   device: DeviceLike = None) -> torch.Generator:
    """The generator of one step's frontend draws, seeded from (seed,
    step) (the reference folds the step into its key)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed((seed << 32) + step)
    return gen


def build_batch(cfg, data_batch: Dict[str, np.ndarray],
                gen: torch.Generator, device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """One step's model inputs on ``device``: the pipeline's tokens and
    labels, plus ``frames`` [B, S, D] for the encoder-decoder and
    ``soft_emb`` [B, frontend_tokens, D] for a vision config, from the stub
    frontends drawn from ``gen`` (the reference's ``build_batch``)."""
    dev = resolve_device(device)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data_batch.items()}
    b, s = batch["tokens"].shape
    if cfg.family == "encdec":
        batch["frames"] = audio_frames(gen, cfg, b, s, dev)
    if cfg.frontend == "vision":
        batch["soft_emb"] = vision_patches(gen, cfg, b, dev)
    return batch


def install_fabric_topology(spec: str):
    """Parse a ``--fabric`` spec (``pod=slow,data=fast`` or a JSON path)
    and install an engine with those per-axis constants as the process
    default, so the grad sync is planned against the declared links."""
    from repro_torch.collectives.api import set_engine
    from repro_torch.collectives.engine import CollectiveEngine
    from repro_torch.core.model import TPU_V5E_AXIS, parse_fabric_topology

    topo = parse_fabric_topology(spec)
    for dev in ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",):
        engine = CollectiveEngine(fabric=topo, device=dev)
        set_engine(engine)
        # call sites ask for the stock default fabric: pin the topology
        # engine under that key too
        set_engine(engine, fabric=TPU_V5E_AXIS)
    return topo


def checkpoint_template(cfg, grad_sync: Optional[GradSyncConfig] = None
                        ) -> TrainState:
    """The train state's shapes and dtypes as meta tensors, the template
    a checkpoint restores into (``CheckpointManager.restore(...,
    device=)``).  Under an FSDP sync over DP axes the moments are this
    rank's flat float32 shard, as ``fsdp_sync_apply`` keeps them."""
    params = init_params(cfg, device="meta")
    state = init_train_state(params)
    if grad_sync is None or grad_sync.mode != "fsdp" or not grad_sync.axes:
        return state
    shard = fsdp_layout(params, grad_sync)[3]
    flat = lambda: torch.empty(shard, dtype=torch.float32, device="meta")
    return TrainState(params=params,
                      opt=AdamWState(mu=flat(), nu=flat(), count=0))


def run(arch: Union[str, ArchConfig], steps: int, batch_size: int,
        seq_len: int, reduced: bool = True, ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50, lr: float = 3e-4, microbatches: int = 1,
        log_every: int = 10, resume: bool = True, device: DeviceLike = None,
        dp: bool = False, grad_sync_mode: str = "allreduce",
        fused: bool = False, fabric_spec: Optional[str] = None,
        moe_ep: Optional[str] = None, num_experts: Optional[int] = None,
        trace: Optional[str] = None, obs_report: bool = False,
        metrics_out: Optional[str] = None) -> List[float]:
    """Train ``arch`` (a name, ``.reduced()`` with ``reduced``, or an
    ``ArchConfig`` taken as it is) for ``steps`` steps on synthetic data;
    returns the loss of every step this run took (under ``dp`` the global
    batch's, on every rank): after a resume only the new steps, after a
    preemption only those before it.  ``ckpt_dir`` / ``ckpt_every`` /
    ``resume``: checkpoints (the module docstring).  ``trace`` /
    ``obs_report`` / ``metrics_out``: the obs flags
    (:mod:`repro_torch.obs.cli`)."""
    dev = resolve_device(device)
    obs_cli.begin(trace, obs_report, metrics_out)
    if fabric_spec:
        topo = install_fabric_topology(fabric_spec)
        print(f"[train] fabric topology: {topo.describe()}")
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = get_config(arch)
        if reduced:
            cfg = cfg.reduced()
    if num_experts is not None:
        cfg = dataclasses.replace(cfg, num_experts=num_experts)
    if moe_ep is not None:
        if cfg.family != "moe":
            raise SystemExit(f"--moe-ep needs an MoE architecture; "
                             f"{cfg.name} is family={cfg.family!r}")
        cfg = dataclasses.replace(cfg, moe_ep=True,
                                  moe_ep_algorithm=moe_ep)
        print(f"[train] expert-parallel MoE dispatch: "
              f"all_to_all[{moe_ep}]")
    if fused or cfg.fused_tp:
        set_fused_tp(True)
        print("[train] fused matmul+reduce-scatter executor enabled")
    schedule = "wsd" if cfg.name == "minicpm-2b" else "cosine"
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule=schedule)

    grid, grad_sync, rows = None, None, None
    owns_world = dp and not dist.is_initialized()
    if dp:
        grid = make_dp_grid(dev)
        dev = grid.device
        axes = grad_sync_axes_for_grid(grid)
        grad_sync = GradSyncConfig(grid=grid, axes=axes,
                                   mode=grad_sync_mode, fused=fused)
        n_dp = math.prod(grid.axis_size(a) for a in axes)
        if axes and batch_size % n_dp == 0:
            per = batch_size // n_dp
            start = grid.axes_index(axes) * per
            rows = slice(start, start + per)
        elif n_dp > 1:
            print(f"[train] WARNING: batch {batch_size} not divisible by "
                  f"DP world {n_dp}; batch stays replicated (no DP "
                  f"speedup, sync path still exercised)")
        print(f"[train] dp grid {dict(zip(grid.axis_names, grid.shape))} "
              f"rank {grid.rank} grad-sync axes {axes} "
              f"mode={grad_sync_mode}" + (" fused" if fused else ""),
              flush=True)
    lead = grid is None or grid.rank == 0
    world = grid.size if grid is not None and dist.is_initialized() else 1
    # under an FSDP sync each rank holds its own shard of the moments
    sharded = (grad_sync is not None and grad_sync.mode == "fsdp"
               and bool(grad_sync.axes))
    start_step, state, mgr = 0, None, None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=2,
                                process_index=grid.rank if sharded else 0,
                                async_save=True)
        if resume and mgr.committed_steps():
            start_step, state, _ = mgr.restore(
                checkpoint_template(cfg, grad_sync), device=dev)
            if lead:
                print(f"[train] resumed from step {start_step}", flush=True)
    if state is None:
        state = init_train_state(init_params(cfg, seed=0, device=dev))
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=batch_size))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              grad_sync=grad_sync)

    def save(step: int, loss: float, block: bool) -> None:
        """Commit ``state`` as ``step``: rank 0 alone when every rank
        holds the whole state, else every rank its shard, rank 0 (whose
        save writes COMMIT) after the others' writes."""
        if world > 1 and not lead:
            if sharded:
                mgr.save(step, state, metadata={"loss": loss})
            dist.barrier()
            return
        if world > 1:
            dist.barrier()
        mgr.save(step, state, metadata={"loss": loss}, block=block)

    previous_handler = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(install=True)
    stragglers = StragglerDetector()
    host = f"host{grid.rank if grid is not None else 0}"
    losses = []
    saved = None        # the last step saved
    t_start = time.time()
    try:
        for step in range(start_step, steps):
            t0 = time.time()
            # the global batch, then this rank's rows of it: every rank's
            # frontend draws are its rows of the one global draw
            batch = build_batch(cfg, data.batch(step),
                                step_generator(0, step, dev), dev)
            if rows is not None:
                batch = {k: v[rows] for k, v in batch.items()}
            with ambient_grid(grid):
                state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            stragglers.record(host, time.time() - t0)
            if lead and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step={step} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={time.time() - t0:.2f}s", flush=True)
            if mgr and (step + 1) % ckpt_every == 0:
                save(step + 1, loss, block=False)
                saved = step + 1
            if _stop_requested(guard, world, dev):
                if lead:
                    print(f"[train] preemption requested: checkpointing "
                          f"step {step + 1} and exiting", flush=True)
                if mgr and saved != step + 1:
                    save(step + 1, loss, block=True)
                    saved = step + 1
                break
        else:
            # the loop ran to its end (C29: never after a preemption)
            if mgr and losses and saved != steps:
                save(steps, losses[-1], block=True)
        if mgr:
            mgr.wait()
            if world > 1:
                dist.barrier()      # no rank leaves before the commit
        # every rank, while the world is up: a process grid replays in
        # lockstep
        obs_cli.finish(trace, obs_report, metrics_out, grid=grid,
                       device=dev, label="train")
    finally:
        _reinstall(previous_handler)
        if owns_world and dist.is_initialized():
            dist.destroy_process_group()
    if lead:
        span = (f"loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses
                else f"nothing to do at step {start_step}")
        _say(f"[train] done: {len(losses)} steps of {cfg.name} on {dev} in "
             f"{time.time() - t_start:.1f}s; {span}")
        if mgr and mgr.history:
            _say(f"[train] checkpoints in {ckpt_dir}: "
                 + _checkpoint_summary(mgr))
    if grid is not None and grid.size > 1:
        # every rank's losses, to hold them equal across the world
        _say(f"[train] rank {grid.rank} losses "
             + " ".join(f"{x:.6f}" for x in losses))
    return losses


def _stop_requested(guard: PreemptionGuard, world: int,
                    dev: torch.device) -> bool:
    """Whether a SIGTERM reached this rank, or with ``world`` > 1 any
    rank (one flag reduced over the world each step, so that every rank
    stops after the same step)."""
    if world == 1:
        return guard.should_stop
    flag = torch.tensor([int(guard.should_stop)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _reinstall(handler) -> None:
    """Put back the SIGTERM handler the run found (the guard's is the
    run's own)."""
    if handler is None:
        return
    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass    # not the main thread: the guard installed nothing


def _checkpoint_summary(mgr: CheckpointManager) -> str:
    parts = []
    for rec in mgr.history:
        gb = rec["bytes"] / 1e9
        if rec["op"] == "restore":
            parts.append(f"restored step {rec['step']} ({gb:.3f} GB) in "
                         f"{rec['read_s']:.2f}s")
        else:
            parts.append(f"saved step {rec['step']} ({gb:.3f} GB; loop "
                         f"blocked {rec['blocked_s']:.2f}s, written in "
                         f"{rec.get('write_s', float('nan')):.2f}s)")
    return "; ".join(parts)


def _say(line: str) -> None:
    """Print ``line`` in one write with its newline: the ranks' last
    lines, printed together into a shared pipe, never interleave (an
    unbuffered ``print`` writes the newline apart)."""
    print(line + "\n", end="", flush=True)


def main(argv: Optional[List[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--dp", action="store_true",
                    help="hierarchical (pod, data) DP over the "
                         "torch.distributed world (torchrun); gradient "
                         "sync through the collective planner")
    ap.add_argument("--grad-sync", choices=("allreduce", "fsdp"),
                    default="allreduce",
                    help="engine sync shape under --dp: bucketed "
                         "allreduce or the FSDP RS/AG pair")
    ap.add_argument("--fused", action="store_true",
                    help="route the grad sync (and the TP "
                         "down-projection, when a model axis exists) "
                         "through the engine's fused matmul + "
                         "reduce-scatter")
    ap.add_argument("--fabric", default=None, metavar="SPEC",
                    help="fabric topology: 'pod=slow,data=fast' "
                         "(presets or link_bw multipliers) or a JSON "
                         "topology file; the planner prices each axis "
                         "with its declared link constants")
    ap.add_argument("--moe-ep", nargs="?", const="auto", default=None,
                    metavar="ALGO",
                    help="route MoE expert dispatch/combine through "
                         "explicit all-to-all (models/moe_ep.py): "
                         "'lax' = the native exchange, else an engine "
                         "algorithm or plan shape ('auto', "
                         "'hierarchical', 'ring', ...; default auto)")
    ap.add_argument("--experts", type=int, default=None,
                    help="override num_experts (e.g. to tile the EP "
                         "world under --reduced)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory: save every --ckpt-every "
                         "steps and at the end, resume from its newest "
                         "committed step")
    ap.add_argument("--ckpt-every", type=int, default=50)
    obs_cli.add_obs_args(ap)
    args = ap.parse_args(argv)
    return run(args.arch, args.steps, args.batch, args.seq,
               reduced=args.reduced, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, lr=args.lr,
               microbatches=args.microbatches, log_every=args.log_every,
               device=args.device, dp=args.dp,
               grad_sync_mode=args.grad_sync, fused=args.fused,
               fabric_spec=args.fabric, moe_ep=args.moe_ep,
               num_experts=args.experts, trace=args.trace,
               obs_report=args.obs_report, metrics_out=args.metrics_out)


if __name__ == "__main__":
    main()
