"""Measured replay: backfill wall time into spans that carry none.

The port of ``repro/obs/replay.py``.  A span records ``measured_s`` only
when the tracer measures (``enable_tracing(measure=True)``), which
synchronises the device after every collective; without it the hot path
runs untaxed and this module recovers the measurement afterwards: for
every unique collective *signature* ``(op, axes, bytes, algorithm)`` in
a trace it runs the same engine call on a :class:`GridComm`, times it
(the first call excluded, best of ``repeats``, the device synchronised
around each call) and writes the result into every span carrying that
signature (``measured_s`` + ``measured_via="replay"``).

Where the reference builds a jitted ``shard_map`` on a mesh, the port
runs the call on every rank of the grid:

* a :class:`LocalGridComm` (threads) is replayed through
  :func:`run_local_grid` over its shape, axis names and device, so call
  it from outside the rank threads (any rank's grid describes the run);
* a :class:`ProcessGroupGrid` is replayed on this process's rank: every
  process of the grid must call :func:`measure_spans` in lockstep with
  the same spans, and the signatures run in sorted order.

A collective runs on every rank, so a signature is counted once
whichever ranks' spans carry it.  The tracer is off during a replay.
The engine's decision and plan caches are warm from the traced run, so
the replay executes the plan the span recorded.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.collectives.comm import GridComm, LocalGridComm, \
    run_local_grid
from repro_torch.obs import trace as obs_trace

Signature = Tuple[str, Tuple[str, ...], int, str]

#: ops the replay knows how to reconstruct a payload for
_REPLAYABLE = ("allreduce", "reduce_scatter", "allgather", "all_to_all")


def span_signature(span) -> Optional[Signature]:
    """The replayable identity of a collective span (None when the
    span is not a replayable engine collective)."""
    args = span.args
    op = args.get("op")
    axes = args.get("axes")
    nbytes = args.get("bytes")
    if op not in _REPLAYABLE or not axes or not nbytes:
        return None
    algo = args.get("algorithm") or "auto"
    if algo == "identity":
        return None
    return (str(op), tuple(str(a) for a in axes), int(nbytes), str(algo))


def _hosts(grid: GridComm, sig: Signature) -> bool:
    """Whether ``grid`` has every axis the signature ran over."""
    return all(a in grid.axis_names for a in sig[1])


def _build_call(engine, grid: GridComm, sig: Signature):
    """A zero-argument callable that runs the signature's engine call on
    this rank of ``grid`` (a fresh local payload of zeros)."""
    op, axes, nbytes, algo = sig
    p = math.prod(grid.axis_size(a) for a in axes)
    multi = len(axes) > 1
    where = grid if multi else grid.sub(axes[0])

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros((max(1, n),), dtype=torch.float32,
                           device=grid.device)

    if op == "allreduce":
        x = zeros(nbytes // 4)
    elif op == "reduce_scatter":
        x = zeros(p * max(1, nbytes // (4 * p)))
    elif op == "allgather":
        # span nbytes is the *global* gathered size (the model's B)
        n = max(1, nbytes // 4)
        x = zeros((n + (-n) % p) // p)
    else:
        # all_to_all: span nbytes is the per-rank block, [p * m] rows
        x = zeros(p * max(1, nbytes // (4 * p)))
    if multi:
        fn = getattr(engine, op + "_multi")
        return lambda: fn(x, grid, axes, algo)
    fn = getattr(engine, op + "_inside")
    return lambda: fn(x, where, algo)


def _timed_best(call, repeats: int) -> float:
    """Best wall of ``repeats`` calls after one untimed call, the device
    synchronised before and after each."""
    obs_trace.synchronize_result(call())
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = call()
        obs_trace.synchronize_result(out)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_signature(engine, grid: GridComm, sig: Signature,
                      repeats: int = 3) -> Optional[float]:
    """Wall seconds for one collective signature on the grid (best of
    ``repeats``, the first call excluded), or None when not
    replayable.  Rank 0's time on a thread grid; this process's on a
    process grid."""
    if not _hosts(grid, sig):
        return None
    tracer = obs_trace.get_tracer()
    was_enabled = tracer.enabled
    tracer.enabled = False      # replay must not re-enter the trace
    try:
        if isinstance(grid, LocalGridComm):
            secs = run_local_grid(
                lambda g: _timed_best(_build_call(engine, g, sig), repeats),
                grid.shape, grid.axis_names, grid.device)
            return secs[0]
        return _timed_best(_build_call(engine, grid, sig), repeats)
    finally:
        tracer.enabled = was_enabled


def measure_spans(spans: List[Any], grid: GridComm, engine=None,
                  repeats: int = 3,
                  only_missing: bool = True) -> Dict[Signature, float]:
    """Backfill ``measured_s`` into every replayable span.

    Spans that already carry a measurement keep it unless
    ``only_missing=False``.  The signatures run in sorted order (every
    process of a process grid must pass the same spans).  Returns
    ``{signature: seconds}`` for the signatures actually measured."""
    if engine is None:
        from repro_torch.collectives.api import get_engine
        engine = get_engine(device=grid.device)
    sigs: Dict[Signature, List[Any]] = {}
    for sp in spans:
        if getattr(sp, "cat", None) != obs_trace.CAT_COLLECTIVE:
            continue
        if only_missing and sp.args.get("measured_s") is not None:
            continue
        sig = span_signature(sp)
        if sig is not None:
            sigs.setdefault(sig, []).append(sp)
    measured: Dict[Signature, float] = {}
    for sig in sorted(sigs):
        secs = measure_signature(engine, grid, sig, repeats=repeats)
        if secs is None:
            continue
        measured[sig] = secs
        for sp in sigs[sig]:
            sp.set(measured_s=secs, measured_via="replay")
    return measured


__all__ = ["measure_spans", "measure_signature", "span_signature"]
