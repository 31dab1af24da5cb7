#!/usr/bin/env python3
"""The control and the faults of a training cell's comparison, read on
the card at the cell's own size (not part of a benchmark run):

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13

For each seed it prints one JSON line of the numbers that
``perfbench/lib/checks.py`` compares, as each stand-in gives them:
``control`` (the plain reference in float8 e4m3 with one scale a
tensor, e5m2 gradients, put in the program's place) and ``half_batch``
(the reference on half of each batch's rows, the mean taken over
them), each against the float32 reference.  A state left unchanged
reads 1 by the measure and needs no run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import checks, env, manifest  # noqa: E402


def train_readings(cell, seed: int, device) -> dict:
    from perfbench.drivers.train import reference_steps
    arch, tr = cell.config["arch"], cell.traffic
    n = tr["check_steps"]
    ref = reference_steps(arch, tr, seed, device, n)
    return {
        "control": checks.train_numbers(
            reference_steps(arch, tr, seed, device, n, "fp8"), ref),
        "half_batch": checks.train_numbers(
            reference_steps(arch, tr, seed, device, n,
                            rows_used=tr["rows"] // 2), ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    env.setup_environment()
    import torch
    cell = manifest.load_cell(args.workload)
    device = torch.device("cuda")
    for seed in args.seeds:
        t = time.time()
        r = train_readings(cell, seed, device)
        print(json.dumps({"seed": seed, "seconds": time.time() - t, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
