"""Training CLI of the port, one device: data pipeline -> train loop, on
CUDA by default.

    python -m repro_torch.launch.train --arch falcon-mamba-7b --reduced \\
        --steps 20 --batch 4 --seq 128 --device cpu
    python -m repro_torch.launch.train --arch minicpm-2b --reduced \\
        --steps 5 --batch 4 --seq 64 --device cpu

On a GPU the hand-written kernels run: the SSM's scan (forward with
chunk checkpoints, recomputing backward) and the dense family's
attention over sequences longer than 2048 (the flash kernel); on the
CPU, which runs only when asked for with ``--device cpu``, their plain
chunked versions.  ``minicpm-2b`` trains with the WSD schedule, every
other architecture with cosine, as in the reference.  The flags are the
reference CLI's single-device ones plus ``--device``; the weights are
random from seed 0, as the reference's.  The dense and SSM families
train here; the other families, data parallelism (``--dp``,
``--grad-sync``, ``--fused``, ``--fabric``), expert parallelism,
checkpoints and the observability flags are later slices of the port
(ROADMAP.md A) and are not offered yet.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step


def run(arch: str, steps: int, batch_size: int, seq_len: int,
        reduced: bool = True, lr: float = 3e-4, microbatches: int = 1,
        log_every: int = 10, device: DeviceLike = None) -> List[float]:
    """Train ``arch`` for ``steps`` steps on synthetic data; returns the
    loss of every step."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    schedule = "wsd" if arch == "minicpm-2b" else "cosine"
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule=schedule)
    state = init_train_state(init_params(cfg, seed=0, device=dev))
    data = SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=batch_size))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    losses = []
    t_start = time.time()
    for step in range(steps):
        t0 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={time.time() - t0:.2f}s", flush=True)
    print(f"[train] done: {len(losses)} steps of {cfg.name} on {dev} in "
          f"{time.time() - t_start:.1f}s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    return losses


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
    args = ap.parse_args(argv)
    return run(args.arch, args.steps, args.batch, args.seq,
               reduced=args.reduced, lr=args.lr,
               microbatches=args.microbatches, log_every=args.log_every,
               device=args.device)


if __name__ == "__main__":
    main()
