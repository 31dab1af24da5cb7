"""Observability flags shared by the launch CLIs.

The port of ``repro/obs/cli.py``.  ``launch/train.py`` and
``launch/serve.py`` expose the same three flags; this module owns their
lifecycle so the CLIs stay thin:

* ``--trace PATH`` -- collect engine spans and export Chrome-trace
  JSON (load in ``chrome://tracing`` / Perfetto);
* ``--obs-report`` -- print the predicted-vs-measured model-error
  table after the run;
* ``--metrics-out PATH`` -- dump the process metrics registry (engine
  cache stats, serving telemetry when present) as JSON.

``begin()`` before the run turns tracing on (measuring: each collective
span synchronises the device, so ``measured_s`` is the call's wall
time) when any flag asks for it; ``finish()`` after the run backfills
wall time into spans that carry none by replaying each unique signature
on the run's grid, then writes the requested artifacts.  With more than
one ``torch.distributed`` process each process writes its own files,
its rank before the extension (``trace.rank1.json``), and rank 0 prints
the report.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch.distributed as dist

from repro_torch.obs import model_error as obs_model_error
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import trace as obs_trace


def add_obs_args(ap) -> None:
    """Install ``--trace`` / ``--obs-report`` / ``--metrics-out`` on an
    ``argparse`` parser."""
    ap.add_argument("--trace", default=None, metavar="PATH",
                    dest="trace",
                    help="export engine collective spans as "
                         "Chrome-trace JSON to PATH (each span carries "
                         "the chosen plan, cache status, predicted "
                         "cost, and measured wall time); with more than "
                         "one process each writes its own file, its rank "
                         "before the extension (PATH.rank<r>.json)")
    ap.add_argument("--obs-report", action="store_true",
                    dest="obs_report",
                    help="print the predicted-vs-measured model-error "
                         "table after the run (implies span tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    dest="metrics_out",
                    help="dump the process metrics registry (engine "
                         "stats, serving telemetry) as JSON to PATH "
                         "(one file a process, as --trace)")


def wants_obs(trace: Optional[str], obs_report: bool,
              metrics_out: Optional[str]) -> bool:
    return bool(trace or obs_report or metrics_out)


def begin(trace: Optional[str] = None, obs_report: bool = False,
          metrics_out: Optional[str] = None) -> bool:
    """Enable span collection when any obs flag asks for it.  Returns
    whether observability is active (callers pass that to
    :func:`finish`)."""
    if not wants_obs(trace, obs_report, metrics_out):
        return False
    if trace or obs_report:
        obs_trace.enable_tracing(measure=True)
    return True


def _process_rank() -> tuple:
    """(rank, world size) of this process's ``torch.distributed``
    world; (0, 1) outside one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def per_process_path(path: str) -> str:
    """``path`` with this process's rank before the extension when the
    world has more than one process, else ``path``."""
    rank, world = _process_rank()
    if world <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


def finish(trace: Optional[str] = None, obs_report: bool = False,
           metrics_out: Optional[str] = None, grid=None, engine=None,
           telemetry_snapshot: Any = None, label: str = "run",
           replay_repeats: int = 3, device=None) -> None:
    """Write the artifacts the obs flags asked for.

    ``grid`` (this rank's :class:`GridComm`, when the run had one)
    drives the measured replay that backfills wall time into spans
    without it; with a process grid every process must call this in
    lockstep.  ``engine`` defaults to the process engine on the grid's
    device (else on ``device``, CUDA by default);
    ``telemetry_snapshot`` (serving) is exported into the registry
    alongside the engine stats."""
    if not wants_obs(trace, obs_report, metrics_out):
        return
    if engine is None:
        from repro_torch.collectives.api import get_engine
        engine = get_engine(device=device if grid is None
                            else grid.device)
    rank, _ = _process_rank()
    tracer = obs_trace.get_tracer()
    spans = tracer.spans
    if (trace or obs_report) and grid is not None and spans:
        from repro_torch.obs import replay
        measured = replay.measure_spans(spans, grid, engine=engine,
                                        repeats=replay_repeats)
        print(f"[{label}] obs: replayed {len(measured)} unique "
              f"collective signatures for wall time")
    if trace:
        path = per_process_path(trace)
        n = tracer.export_chrome(path)
        print(f"[{label}] obs: wrote {n} spans to {path}")
    if obs_report and rank == 0:
        mon = obs_model_error.ModelErrorMonitor()
        mon.observe_spans(spans)
        print(mon.render_table())
    if metrics_out:
        obs_registry.export_engine_stats(engine)
        if telemetry_snapshot is not None:
            from repro_torch.serving.telemetry import export_to_registry
            export_to_registry(telemetry_snapshot)
        path = per_process_path(metrics_out)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(obs_registry.REGISTRY.export_json(), f, indent=2,
                      sort_keys=True)
        print(f"[{label}] obs: wrote metrics registry to {path}")


__all__ = ["add_obs_args", "wants_obs", "begin", "finish",
           "per_process_path"]
