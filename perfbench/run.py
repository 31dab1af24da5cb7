#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the port (``src/repro_torch``).  The cell names its configuration
(``perfbench/configs/``), its traffic (``perfbench/traffic/``, read by
the driver of its ``kind`` in ``perfbench/drivers/``), the limits of its
comparison (``perfbench/workloads/<cell>.json``) and, through
``BENCHMARK.json``, the readers of its per-layer metrics
(``perfbench/metrics/<metric>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds
every number compared beside its limit, which also close standard
error.  Every cell runs on one card.

Exit codes: 0 with a result; 2 without the cards the cell asks for;
3 when a module of JAX or of the JAX package was loaded; anything else
is an error of the run.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.lib import checks, env, manifest  # noqa: E402


def driver(cell):
    import importlib
    return importlib.import_module(
        f"perfbench.drivers.{cell.traffic['kind']}")


def run_cell(cell, seed: int, seconds: float, trace: bool,
             t_start: float = T_START, device_type: str = "cuda") -> dict:
    """The cell run once on one card: the driver's result, with
    ``setup_s``."""
    if cell.chips != 1:
        raise ValueError(f"{cell.name} asks for {cell.chips} cards; this "
                         f"harness runs one-card cells only")
    import torch
    res = driver(cell).run(cell, seed, seconds, trace,
                           torch.device(device_type))
    res["setup_s"] = res["open_wall"] - t_start
    return res


def _finite(x):
    """A number as JSON can hold it: null for NaN and infinities."""
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell, res: dict, trace: bool, device_type: str,
                limits: dict) -> tuple:
    """(the JSON object printed, the compared rows)."""
    correct, rows = checks.judge(res.get("numbers", {}), limits)
    metrics = {}
    if not trace:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for m in cell.end_to_end:
            metrics[m.name] = {"value": _finite(values[m.name]),
                               "unit": m.unit}
    else:
        ctx = {"arch": cell.config["arch"], "traffic": cell.traffic,
               "counts": res["counts"], "trace": res["trace"]}
        for m in cell.per_layer:
            value = m.read(ctx)
            if value is not None:
                metrics[m.name] = {"value": _finite(value), "unit": m.unit}
    if device_type == "cuda":
        device = env.device_record(cell.chips, res["peak"])
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": cell.chips,
                  "memory_peak_bytes": 0}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = res["trace"]["breakdown"]
    if device_type == "cuda":
        line["card"] = env.power_limit()
    line["detail"] = res.get("numbers", {}).get("detail", {})
    line["checks"] = {name: {"value": _finite(value), "limit": limit}
                      for name, value, limit in rows}
    return line, rows


def summary(res: dict) -> str:
    """One line for the log: where set-up went (seconds from the
    process's start to each phase's end), the window and its work, and
    how long the reference took."""
    phases = {k: round(v - T_START, 2)
              for k, v in res.get("phases", {}).items()}
    counts = {k: v for k, v in res["counts"].items()
              if isinstance(v, (int, float))}
    return (f"set-up {res['setup_s']:.2f} s by phase {phases}; window "
            f"{res['window_s']:.3f} s, {counts}; reference "
            f"{res.get('reference_s', 0):.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    env.setup_environment()
    import torch

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = env.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or of the JAX package were "
              f"loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    line, rows = result_line(cell, res, bool(args.trace), "cuda",
                             checks.limits(cell.name))
    print(f"perfbench: {summary(res)}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
