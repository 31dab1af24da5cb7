"""Training traffic: the port's optimizer step (``train.step.
make_train_step``) driven step after step on synthetic batches drawn
from the seed, on one card.

Set-up builds the one step object with its model and optimizer state,
drives it through the traffic's first ``check_steps`` steps (which warm
every shape) and reads what the comparison needs: each step's loss, the
first gradient as the optimizer got it (from its first moment) and,
after the last, each leaf's change (from the float32 master weights).
The window then runs steps until ``--seconds`` have passed: the rate is
the tokens of the completed steps over the time from the
window's first step start to its last step's end.  Once the window has
closed and the program's state is freed, the plain reference follows
the same first steps from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Optional

import torch

from perfbench.lib import checks, profile, weights
from perfbench.reference import model as ref_model

def batch(seed: int, step: int, rows: int, seq: int, vocab: int,
          device, used: Optional[int] = None) -> dict:
    """The first ``used`` (default: all) of step ``step``'s batch of
    ``rows`` rows: uniform token ids, the labels the next position's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.seed64(seed * 1_000_003 + 7919 * (step + 1)))
    ids = torch.randint(0, vocab, (rows, seq + 1), generator=gen,
                        device=device)[:used]
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def opt_config(tr: dict):
    from repro_torch.optim.adamw import AdamWConfig
    o = tr["optimizer"]
    return AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                       weight_decay=o["weight_decay"],
                       grad_clip=o["grad_clip"],
                       master_weights=o["master_weights"],
                       schedule=o["schedule"],
                       warmup_steps=o["warmup_steps"],
                       total_steps=o["total_steps"],
                       decay_fraction=o["decay_fraction"],
                       min_lr_ratio=o["min_lr_ratio"])


def program_config(arch: dict):
    """The port's ``ArchConfig`` from the configuration file's ``arch``
    (keys it does not know, such as the reference's, are left out)."""
    from repro_torch.configs.base import ArchConfig
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in arch.items() if k in names})


def free_device() -> None:
    """Free what the program or the reference left on the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device) -> dict:
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    arch, tr = cell.config["arch"], cell.traffic
    rows, seq = tr["rows"], tr["seq"]
    cfg = program_config(arch)

    phases = {"entered": time.time()}
    params = weights.make_tree(arch, seed, device)
    state = init_train_state(
        params, master_weights=tr["optimizer"]["master_weights"])
    del params
    step_fn = make_train_step(cfg, opt_config(tr), remat=True)
    _sync(device)
    phases["weights_and_state"] = time.time()

    def step(i: int):
        nonlocal state
        b = batch(seed, i, rows, seq, arch["vocab_size"], device)
        with profile.mark("train_step"):
            state, metrics = step_fn(state, b)
            loss = float(metrics["loss"])          # waits for the device
        return loss, metrics

    # -- set-up: the first steps, read for the comparison -------------- #
    n_check = tr["check_steps"]
    prog = {"loss": [], "grad": {}, "change": {}}
    for i in range(n_check):
        loss, metrics = step(i)
        phases[f"check_step_{i}"] = time.time()
        prog["loss"].append(loss)
        if i == 0:
            gnorm = float(metrics["grad_norm"])
            o = tr["optimizer"]
            scale = min(1.0, o["grad_clip"] / (gnorm + 1e-9))
            for path, *_ in weights.leaf_specs(arch):
                mu = weights.get(state.opt.mu, path)
                prog["grad"][weights.name(path)] = (
                    float(mu.norm()) / (1 - o["b1"]) / scale)
    # the weights step 4 starts from: the float32 masters, if kept
    kept = state.params if state.opt.master is None else state.opt.master
    prog["change"] = weights.change_norms(
        arch, seed, device, lambda path: weights.get(kept, path))
    _sync(device)
    phases["change_norms"] = time.time()

    # -- the window ---------------------------------------------------- #
    losses = []
    i = n_check
    with profile.traced(trace) as traced:
        open_wall = time.time()
        t0 = time.perf_counter()
        with profile.window_range():
            while True:
                loss, _ = step(i)
                losses.append(loss)
                i += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            t1 = time.perf_counter()
    window_s = t1 - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    steps = len(losses)
    failed = sum(not math.isfinite(x) for x in losses)
    out = {"open_wall": open_wall, "window_s": window_s, "peak": peak,
           "attempted": steps, "failed": failed, "phases": phases,
           "e2e": {"train_tokens_per_s": steps * rows * seq / window_s},
           "counts": {"steps": steps, "rows": rows, "seq": seq}}
    if trace:
        out["trace"] = traced["trace"].summary()
    del state, step_fn
    free_device()

    # -- the reference over the same first steps ----------------------- #
    t_ref = time.time()
    ref = reference_steps(arch, tr, seed, device, n_check)
    out["reference_s"] = time.time() - t_ref
    out["numbers"] = checks.train_numbers(prog, ref)
    return out


def reference_steps(arch: dict, tr: dict, seed: int, device,
                    n_steps: int, precision: str = "fp32",
                    rows_used: Optional[int] = None) -> dict:
    """The plain reference's ``n_steps`` steps from the seed's weights
    on the same batches: each step's loss, the first gradient's leaf
    norms and the leaves' change.  ``rows_used`` plants a fault the
    comparison must catch (the rest of each batch left out)."""
    rows, seq = tr["rows"], tr["seq"]
    params = weights.make_tree(arch, seed, device, torch.float32)
    opt = ref_model.AdamW(params, tr["optimizer"])
    out = {"loss": [], "grad": {}, "change": {}}
    for i in range(n_steps):
        b = batch(seed, i, rows, seq, arch["vocab_size"], device,
                  rows_used)
        loss, grads = ref_model.loss_and_grads(params, arch, b["tokens"],
                                               b["labels"], precision)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = {n: float(g.norm()) for n, g in grads.items()}
        opt.step(grads)
        del grads
    out["change"] = weights.change_norms(
        arch, seed, device, lambda path: weights.get(params, path))
    del params, opt
    free_device()
    return out
