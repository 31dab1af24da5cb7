"""Collective observability of the port: span tracing, model-error
monitoring, and a unified metrics registry (the counterpart of
``repro/obs``, imported from neither JAX nor the JAX package).

* :mod:`repro_torch.obs.trace` -- every engine collective emits a
  structured span (op, axes, bytes, chosen plan, cache status,
  predicted cost, measured wall time, rank) exportable as
  Chrome-trace/Perfetto JSON; ``region`` marks the train step's own
  work (``repro_torch.*`` profiler ranges, step spans).
* :mod:`repro_torch.obs.model_error` -- an online aggregator binning
  spans by (op, topology, bytes-decile) and flagging drift of predicted
  vs measured time past the paper's 4% bound, with a recalibration
  recommendation.
* :mod:`repro_torch.obs.registry` -- counters/gauges/histograms with
  Prometheus-text and JSON exporters; the engine's cache stats and the
  serving telemetry export through it.
* :mod:`repro_torch.obs.replay` -- measured replay of a trace's
  signatures on a grid; :mod:`repro_torch.obs.cli` -- the launch CLIs'
  ``--trace`` / ``--obs-report`` / ``--metrics-out``.

Programmatically::

    from repro_torch import obs
    obs.enable_tracing(measure=True)
    ... run engine collectives ...
    obs.get_tracer().export_chrome("trace.json")
"""

from repro_torch.obs.registry import (Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry, REGISTRY,
                                      EXPORT_SCHEMA, validate_export,
                                      export_engine_stats)
from repro_torch.obs.trace import (Span, Tracer,  # noqa: F401
                                   TRACE_SCHEMA, CAT_COLLECTIVE, CAT_PHASE,
                                   CAT_STEP, region, get_tracer, set_tracer,
                                   enable_tracing, disable_tracing,
                                   load_chrome_trace,
                                   collective_spans, validate_spans)
from repro_torch.obs.model_error import (ModelErrorMonitor,  # noqa: F401
                                         ErrorBin, bytes_decile,
                                         DEFAULT_THRESHOLD)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "EXPORT_SCHEMA", "validate_export", "export_engine_stats",
    "Span", "Tracer", "TRACE_SCHEMA", "CAT_COLLECTIVE", "CAT_PHASE",
    "CAT_STEP", "region", "get_tracer", "set_tracer", "enable_tracing",
    "disable_tracing",
    "load_chrome_trace", "collective_spans", "validate_spans",
    "ModelErrorMonitor", "ErrorBin", "bytes_decile", "DEFAULT_THRESHOLD",
]
