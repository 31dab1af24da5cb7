"""Span tracing for engine collectives: structured spans, Chrome-trace
export, opt-in synchronising measurement.

The port of ``repro/obs/trace.py``.  Every engine collective call emits
one *span* carrying the op, the axes and sizes it ran over, payload
bytes, the chosen plan (``plan.describe()``, ``n_chunks``), whether the
decision came from the cache, and the model's predicted time (Eq.-1
cycles).  Phases executed by the engine's wavefront runner nest as child
spans and are additionally wrapped in ``torch.profiler.record_function``
(the reference's ``jax.named_scope``), so a ``torch.profiler`` trace
lines up with the model's phase decomposition.

One measurement regime.  The reference has two, because its engine
calls run either under ``jax.jit`` tracing (``mode="traced"``, no wall
time) or eagerly; every port call runs eagerly on concrete tensors, so a
port span is always ``mode="eager"`` (ROADMAP C22).  With the tracer's
``measure=True`` (opt-in) a collective span synchronises the result's
CUDA device before it closes, and ``measured_s`` is the call's wall time;
otherwise ``measured_s`` stays None and
:func:`repro_torch.obs.replay.measure_spans` can backfill it.

Ranks.  The port runs a collective on every rank (threads of one process
or one process a rank), where the reference's ``shard_map`` traces it
once; so every rank's span carries its ``rank``, and the consumers that
count calls (the model-error monitor, the replay) read rank 0's.  The
span stack is thread-local: rank threads sharing one tracer each nest
their phases under their own collective span.

Regions.  :func:`region` marks a piece of the program's own work (the
train step, its forward and backward, the attention backward, the
optimizer update, the gradient sync, each collective and phase): a
``torch.profiler.record_function`` range while the profiler records,
which Kineto stamps on the clock of the device's kernel records, and a
never-synchronising span while the tracer is enabled.  Every range name
starts with ``repro_torch.``.  No switch turns regions on: they follow
the profiler and the tracer, and with both off a region costs two flag
checks and the shared no-op.  Step spans (CAT_STEP) nest among
themselves on a stack of their own, so a collective span's parent is a
collective or phase span or none, as without them: the consumers that
take a parentless collective span for one call see the same tree.

Export is Chrome-trace JSON (``chrome://tracing`` / Perfetto: complete
``"X"`` events with span/parent ids in ``args``), loadable back into
:class:`Span` objects via :func:`load_chrome_trace`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

#: span categories (the ``cat`` field of the Chrome events)
CAT_COLLECTIVE = "collective"
CAT_PHASE = "phase"
#: a region of the training step (:func:`region`)
CAT_STEP = "step"

#: schema tag written into the trace metadata (the reference's: a port
#: trace loads in the reference's tools and back)
TRACE_SCHEMA = "repro-trace-v1"

#: args every CAT_COLLECTIVE span must carry
REQUIRED_COLLECTIVE_ARGS = ("op", "axes", "bytes", "plan", "cache",
                            "predicted", "measured_s", "mode")


@dataclasses.dataclass
class Span:
    """One traced operation.  ``t0``/``dur`` are host seconds relative
    to the tracer epoch; ``args`` is the structured payload."""

    span_id: int
    parent_id: Optional[int]
    name: str
    cat: str
    t0: float
    dur: float = 0.0
    tid: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def set(self, **kw: Any) -> None:
        self.args.update(kw)

    @property
    def predicted(self) -> Optional[float]:
        return self.args.get("predicted")

    @property
    def measured_s(self) -> Optional[float]:
        return self.args.get("measured_s")


class _NullSpan:
    """No-op span handed out while tracing is disabled: the hot path
    pays one attribute check and nothing else."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **kw: Any) -> None:
        return None

    def finish_result(self, result: Any, block: Optional[bool] = None
                      ) -> None:
        return None


NULL_SPAN = _NullSpan()


def synchronize_result(result: Any) -> None:
    """Wait for the CUDA work behind ``result`` (a tensor, or a tuple or
    list of them): ``torch.cuda.synchronize`` on each CUDA device found,
    the counterpart of ``jax.block_until_ready``.  CPU tensors are ready
    when returned."""
    items = result if isinstance(result, (tuple, list)) else (result,)
    devices = {x.device for x in items
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class _SpanContext:
    """Context manager binding a live :class:`Span` to the tracer's
    thread-local stack."""

    __slots__ = ("_tracer", "span", "_finished")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span
        self._finished = False

    def __enter__(self) -> "_SpanContext":
        self._tracer._push(self.span)
        return self

    def __exit__(self, *exc: Any) -> None:
        if not self._finished:
            self.span.dur = self._tracer._now() - self.span.t0
        self._tracer._pop(self.span)

    def set(self, **kw: Any) -> None:
        self.span.set(**kw)

    def finish_result(self, result: Any, block: Optional[bool] = None
                      ) -> None:
        """Stamp the mode and (optionally) the measured wall time.
        ``block=None`` synchronises iff the tracer is in measurement
        mode."""
        self.span.set(mode="eager")
        should_block = self._tracer.measure if block is None else block
        if should_block:
            synchronize_result(result)
            self.span.dur = self._tracer._now() - self.span.t0
            self.span.set(measured_s=self.span.dur)
            self._finished = True
        elif "measured_s" not in self.span.args:
            self.span.set(measured_s=None)


class Tracer:
    """Collects spans; disabled by default (every ``span()`` call
    returns the shared no-op)."""

    def __init__(self, enabled: bool = False, measure: bool = False,
                 max_spans: int = 200_000,
                 clock=time.perf_counter):
        self.enabled = enabled
        self.measure = measure
        self.max_spans = max_spans
        self.dropped = 0
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: List[Span] = []
        self._next_id = 0
        #: the optimizer count of the train step running now, which
        #: every CAT_STEP span carries as ``step``
        self.step: Optional[int] = None

    # ------------------------------------------------------------------ #
    def _now(self) -> float:
        return self._clock() - self._epoch

    def _stack(self, cat: str = CAT_COLLECTIVE) -> List[Span]:
        """This thread's open spans: the step regions on a stack of
        their own, every other category on the other."""
        key = "steps" if cat == CAT_STEP else "stack"
        st = getattr(self._local, key, None)
        if st is None:
            st = []
            setattr(self._local, key, st)
        return st

    def _push(self, span: Span) -> None:
        self._stack(span.cat).append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack(span.cat)
        if st and st[-1] is span:
            st.pop()

    # ------------------------------------------------------------------ #
    def span(self, name: str, cat: str = CAT_COLLECTIVE, **args: Any):
        """Open a span (context manager).  Returns the shared no-op
        when tracing is disabled."""
        if not self.enabled:
            return NULL_SPAN
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return NULL_SPAN
            sid = self._next_id
            self._next_id += 1
            st = self._stack(cat)
            parent = st[-1].span_id if st else None
            sp = Span(span_id=sid, parent_id=parent, name=name, cat=cat,
                      t0=self._now(), tid=threading.get_ident() & 0xFFFF,
                      args=dict(args))
            self._spans.append(sp)
        return _SpanContext(self, sp)

    def current_span(self):
        """The innermost live collective or phase span on this thread
        (the one a nested resolution step should annotate), or the
        no-op when tracing is off / no such span is open."""
        if not self.enabled:
            return NULL_SPAN
        st = self._stack()
        return st[-1] if st else NULL_SPAN

    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._next_id = 0
            self.dropped = 0

    # ------------------------------------------------------------------ #
    def to_chrome_events(self) -> List[Dict[str, Any]]:
        events = []
        for sp in self.spans:
            args = dict(sp.args)
            args["span_id"] = sp.span_id
            args["parent_id"] = sp.parent_id
            events.append({
                "name": sp.name, "cat": sp.cat, "ph": "X",
                "ts": sp.t0 * 1e6, "dur": max(sp.dur, 0.0) * 1e6,
                "pid": os.getpid(), "tid": sp.tid, "args": args,
            })
        return events

    def export_chrome(self, path: str) -> int:
        """Write Chrome-trace JSON; returns the number of spans."""
        events = self.to_chrome_events()
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {"schema": TRACE_SCHEMA, "dropped": self.dropped},
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return len(events)


def spans_from_events(events: List[Dict[str, Any]]) -> List[Span]:
    """Rebuild :class:`Span` objects from Chrome events (inverse of
    :meth:`Tracer.to_chrome_events`), ordered by start time then id."""
    spans = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        sid = args.pop("span_id", len(spans))
        parent = args.pop("parent_id", None)
        spans.append(Span(
            span_id=int(sid),
            parent_id=None if parent is None else int(parent),
            name=str(ev.get("name", "")), cat=str(ev.get("cat", "")),
            t0=float(ev.get("ts", 0.0)) / 1e6,
            dur=float(ev.get("dur", 0.0)) / 1e6,
            tid=int(ev.get("tid", 0)), args=args))
    spans.sort(key=lambda s: (s.t0, s.span_id))
    return spans


def load_chrome_trace(path: str) -> List[Span]:
    with open(path) as f:
        payload = json.load(f)
    events = (payload["traceEvents"] if isinstance(payload, dict)
              else payload)
    return spans_from_events(events)


def collective_spans(spans: List[Span]) -> Iterator[Span]:
    for sp in spans:
        if sp.cat == CAT_COLLECTIVE:
            yield sp


def validate_spans(spans: List[Span]) -> List[str]:
    """The trace contract: every collective span carries the
    predicted-cost fields.  Returns problems (empty = conformant)."""
    problems = []
    n_coll = 0
    for sp in collective_spans(spans):
        n_coll += 1
        missing = [k for k in REQUIRED_COLLECTIVE_ARGS if k not in sp.args]
        if missing:
            problems.append(f"span {sp.span_id} ({sp.name}): missing "
                            f"args {missing}")
            continue
        if sp.args.get("predicted") is None and \
                not sp.args.get("algorithm_forced"):
            problems.append(f"span {sp.span_id} ({sp.name}): predicted "
                            f"cost is null on a model-selected span")
    if n_coll == 0:
        problems.append("no collective spans in trace")
    return problems


# ---------------------------------------------------------------------- #
# process-wide tracer
# ---------------------------------------------------------------------- #
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def set_tracer(tracer: Tracer) -> Tracer:
    """Swap the process tracer (tests); returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


def enable_tracing(measure: bool = False, max_spans: int = 200_000
                   ) -> Tracer:
    """Turn on span collection process-wide.  ``measure=True``
    additionally synchronises on collective results to record wall
    time."""
    tracer = get_tracer()
    tracer.enabled = True
    tracer.measure = measure
    tracer.max_spans = max_spans
    return tracer


def disable_tracing() -> None:
    get_tracer().enabled = False


# ---------------------------------------------------------------------- #
# regions: profiler ranges and step spans
# ---------------------------------------------------------------------- #
_autograd_profiler = torch.autograd.profiler


class _Region:
    """A profiler range (when the profiler records) around a span (when
    the tracer is enabled); entering it gives the span's context, or the
    no-op."""

    __slots__ = ("_range", "_span")

    def __init__(self, name: str, span: Any, profiling: bool):
        self._range = (torch.profiler.record_function(name) if profiling
                       else None)
        self._span = span

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        return self._span.__enter__()

    def __exit__(self, *exc: Any) -> None:
        try:
            self._span.__exit__(*exc)
        finally:
            if self._range is not None:
                self._range.__exit__(*exc)


def region(name: str, label: Optional[str] = None, cat: str = CAT_STEP,
           **args: Any):
    """A region of the program's work, as a context manager.

    While ``torch.profiler`` records, a ``record_function`` range
    ``name`` (``repro_torch.<layer>.<what>``): Kineto stamps it on the
    clock of the device's kernel records and ties each kernel launched
    inside it to it.  While the tracer is enabled, also a span of ``cat``
    labelled ``label`` (default ``name``) with ``args``; a CAT_STEP span
    carries the optimizer count as ``step`` (a region given ``step``
    sets it for the regions after it) and never synchronises.  Entering
    gives the span's context (``set``, ``finish_result``) or the no-op.
    With both off: the shared no-op."""
    profiling = _autograd_profiler._is_profiler_enabled
    tracer = _TRACER
    if not tracer.enabled:
        return _Region(name, NULL_SPAN, True) if profiling else NULL_SPAN
    if cat == CAT_STEP:
        if "step" in args:
            tracer.step = args["step"]
        else:
            args["step"] = tracer.step
    return _Region(name, tracer.span(label or name, cat=cat, **args),
                   profiling)


__all__ = ["Span", "Tracer", "NULL_SPAN", "TRACE_SCHEMA",
           "CAT_COLLECTIVE", "CAT_PHASE", "CAT_STEP",
           "REQUIRED_COLLECTIVE_ARGS", "get_tracer", "set_tracer",
           "enable_tracing", "disable_tracing", "region",
           "load_chrome_trace", "spans_from_events", "collective_spans",
           "validate_spans", "synchronize_result"]
