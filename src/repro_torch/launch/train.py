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
its rank before the extension.  Checkpoints (``--ckpt-dir``: ROADMAP.md
A.7 (b)) are a later slice of the port, refused by name.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.collectives.comm import (GridComm, ProcessGroupGrid,
                                          single_rank_grid)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.models.frontend import audio_frames, vision_patches
from repro_torch.models.layers import ambient_grid, set_fused_tp
from repro_torch.obs import cli as obs_cli
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.rules import grad_sync_axes_for_grid
from repro_torch.train.state import init_train_state
from repro_torch.train.step import GradSyncConfig, make_train_step

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


def run(arch: str, steps: int, batch_size: int, seq_len: int,
        reduced: bool = True, lr: float = 3e-4, microbatches: int = 1,
        log_every: int = 10, device: DeviceLike = None, dp: bool = False,
        grad_sync_mode: str = "allreduce", fused: bool = False,
        fabric_spec: Optional[str] = None, moe_ep: Optional[str] = None,
        num_experts: Optional[int] = None, trace: Optional[str] = None,
        obs_report: bool = False,
        metrics_out: Optional[str] = None) -> List[float]:
    """Train ``arch`` for ``steps`` steps on synthetic data; returns the
    loss of every step (under ``dp`` the global batch's, on every
    rank).  ``trace`` / ``obs_report`` / ``metrics_out``: the obs flags
    (:mod:`repro_torch.obs.cli`)."""
    dev = resolve_device(device)
    obs_cli.begin(trace, obs_report, metrics_out)
    if fabric_spec:
        topo = install_fabric_topology(fabric_spec)
        print(f"[train] fabric topology: {topo.describe()}")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if num_experts is not None:
        cfg = dataclasses.replace(cfg, num_experts=num_experts)
    if moe_ep is not None:
        if cfg.family != "moe":
            raise SystemExit(f"--moe-ep needs an MoE architecture; "
                             f"{arch} is family={cfg.family!r}")
        cfg = dataclasses.replace(cfg, moe_ep=True,
                                  moe_ep_algorithm=moe_ep)
        print(f"[train] expert-parallel MoE dispatch: "
              f"all_to_all[{moe_ep}]")
    if fused or cfg.fused_tp:
        set_fused_tp(True)
        print("[train] fused matmul+reduce-scatter executor enabled")
    schedule = "wsd" if arch == "minicpm-2b" else "cosine"
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
    state = init_train_state(init_params(cfg, seed=0, device=dev))
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=batch_size))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                              grad_sync=grad_sync)
    lead = grid is None or grid.rank == 0
    losses = []
    t_start = time.time()
    try:
        for step in range(steps):
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
            if lead and (step % log_every == 0 or step == steps - 1):
                print(f"[train] step={step} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"dt={time.time() - t0:.2f}s", flush=True)
        # every rank, while the world is up: a process grid replays in
        # lockstep
        obs_cli.finish(trace, obs_report, metrics_out, grid=grid,
                       device=dev, label="train")
    finally:
        if owns_world and dist.is_initialized():
            dist.destroy_process_group()
    if lead:
        _say(f"[train] done: {len(losses)} steps of {cfg.name} on {dev} in "
             f"{time.time() - t_start:.1f}s; loss {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}")
    if grid is not None and grid.size > 1:
        # every rank's losses, to hold them equal across the world
        _say(f"[train] rank {grid.rank} losses "
             + " ".join(f"{x:.6f}" for x in losses))
    return losses


def _say(line: str) -> None:
    """Print ``line`` in one write with its newline: the ranks' last
    lines, printed together into a shared pipe, never interleave (an
    unbuffered ``print`` writes the newline apart)."""
    print(line + "\n", end="", flush=True)


#: flags of the reference's CLI that wait for later slices of the port
_LATER = {"ckpt_dir": "--ckpt-dir: checkpoints (ROADMAP.md A.7)"}


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
    ap.add_argument("--ckpt-dir", default=None, help=argparse.SUPPRESS)
    obs_cli.add_obs_args(ap)
    args = ap.parse_args(argv)
    for name, what in _LATER.items():
        if getattr(args, name) not in (None, False):
            ap.error(f"{what} is not ported yet")
    return run(args.arch, args.steps, args.batch, args.seq,
               reduced=args.reduced, lr=args.lr,
               microbatches=args.microbatches, log_every=args.log_every,
               device=args.device, dp=args.dp,
               grad_sync_mode=args.grad_sync, fused=args.fused,
               fabric_spec=args.fabric, moe_ep=args.moe_ep,
               num_experts=args.experts, trace=args.trace,
               obs_report=args.obs_report, metrics_out=args.metrics_out)


if __name__ == "__main__":
    main()
