"""Unified metrics registry: counters, gauges, histograms, one export.

The port of ``repro/obs/registry.py`` (numpy only; its exports equal the
reference's for the same sequence of operations):

* :class:`Counter` -- monotonically increasing (``inc``),
* :class:`Gauge` -- last-write-wins (``set``),
* :class:`Histogram` -- sample accumulator with count/sum and
  percentiles computed at export time,

all addressed by ``(name, labels)`` and exported atomically either as
JSON (:meth:`MetricsRegistry.export_json`, the schema ``--metrics-out``
writes) or Prometheus text exposition format
(:meth:`MetricsRegistry.export_prometheus`).  The engine's cache stats
(:func:`export_engine_stats`), the serving telemetry
(``serving.telemetry.export_to_registry``) and the prefix cache
(:func:`export_prefix_cache_stats`) export through it.

*Collectors* are callables invoked at export time that push fresh
values into the registry (e.g. an engine dumping its stats snapshot),
so one ``export_json()`` call dumps the whole system's state without
every subsystem eagerly mirroring each mutation.
"""

from __future__ import annotations

import json
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

#: schema tag embedded in every JSON export so readers can validate
#: they are looking at a registry dump (the reference's tag).
EXPORT_SCHEMA = "repro-metrics-v1"

Labels = Tuple[Tuple[str, str], ...]


def _freeze_labels(labels: Optional[Dict[str, str]]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _escape_label_value(value: str) -> str:
    """Prometheus exposition escaping for label values: backslash,
    double quote, and line feed must be escaped or the ``k="v"`` pair
    is syntactically invalid (tenant ids and file paths are label
    values under the serving fleet)."""
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_suffix(labels: Labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Prometheus metric names allow ``[a-zA-Z0-9_:]`` only."""
    return _NAME_RE.sub("_", name)


class Counter:
    """Monotonic counter; ``inc`` with a negative delta raises."""

    kind = "counter"

    def __init__(self, name: str, labels: Labels, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(delta={delta})")
        self._value += delta

    @property
    def value(self) -> float:
        return self._value

    def export(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, labels: Labels, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, delta: float = 1.0) -> None:
        self._value += delta

    @property
    def value(self) -> float:
        return self._value

    def export(self) -> float:
        return self._value


class Histogram:
    """Sample accumulator; percentiles computed at export time (the
    sample list is kept, bounded by ``max_samples`` reservoir-style:
    count/sum stay exact, percentiles become approximate past the
    bound)."""

    kind = "histogram"

    def __init__(self, name: str, labels: Labels, help: str = "",
                 max_samples: int = 4096):
        self.name = name
        self.labels = labels
        self.help = help
        self.max_samples = max_samples
        self.count = 0
        self.sum = 0.0
        self._samples: List[float] = []

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if len(self._samples) < self.max_samples:
            self._samples.append(value)
        else:
            # reservoir: overwrite a deterministic slot so exports stay
            # reproducible for a fixed observation sequence
            self._samples[self.count % self.max_samples] = value

    def export(self) -> Dict[str, float]:
        out = {"count": float(self.count), "sum": self.sum}
        if self._samples:
            arr = np.asarray(self._samples, np.float64)
            for q in (50, 90, 99):
                out[f"p{q}"] = float(np.percentile(arr, q))
            out["min"] = float(arr.min())
            out["max"] = float(arr.max())
        return out


class MetricsRegistry:
    """Thread-safe metric store keyed by ``(name, labels)``.

    ``counter`` / ``gauge`` / ``histogram`` get-or-create, so call
    sites just ask for the metric each time; conflicting kinds under
    one name raise.  ``snapshot()`` freezes every metric's exported
    value into plain data under one lock acquisition -- the atomic
    view the exporters (and tests) build on.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, Labels], Any] = {}
        self._collectors: Dict[str, Callable[["MetricsRegistry"], None]] = {}

    # ------------------------------------------------------------------ #
    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             help: str, **kw):
        key = (name, _freeze_labels(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], help=help, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "", max_samples: int = 4096) -> Histogram:
        return self._get(Histogram, name, labels, help,
                         max_samples=max_samples)

    # ------------------------------------------------------------------ #
    def register_collector(self, key: str,
                           fn: Callable[["MetricsRegistry"], None]) -> None:
        """Register (or replace) a collector run at export time."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors.values())
        for fn in collectors:
            fn(self)

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Atomic plain-data view: ``{kind: {name{labels}: value}}``.
        Runs collectors first so lazily-exported subsystems are
        current."""
        self._run_collectors()
        out: Dict[str, Dict[str, Any]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for (name, labels), m in sorted(self._metrics.items()):
                out[m.kind + "s"][name + _label_suffix(labels)] = m.export()
        return out

    def export_json(self) -> Dict[str, Any]:
        """The registry schema ``--metrics-out`` writes: a tagged,
        atomic snapshot."""
        snap = self.snapshot()
        snap["schema"] = EXPORT_SCHEMA
        return snap

    def export_json_str(self, indent: int = 2) -> str:
        return json.dumps(self.export_json(), indent=indent, sort_keys=True)

    def export_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        self._run_collectors()
        lines: List[str] = []
        seen_header = set()
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, labels), m in items:
            pname = _prom_name(name)
            if pname not in seen_header:
                seen_header.add(pname)
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                ptype = ("summary" if m.kind == "histogram" else m.kind)
                lines.append(f"# TYPE {pname} {ptype}")
            suffix = _label_suffix(labels)
            if m.kind == "histogram":
                exp = m.export()
                lines.append(f"{pname}_count{suffix} {exp['count']:g}")
                lines.append(f"{pname}_sum{suffix} {exp['sum']:g}")
                for q in (50, 90, 99):
                    key = f"p{q}"
                    if key in exp:
                        q_labels = labels + (("quantile", f"0.{q}"),)
                        lines.append(f"{pname}"
                                     f"{_label_suffix(q_labels)} "
                                     f"{exp[key]:g}")
            else:
                lines.append(f"{pname}{suffix} {m.export():g}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


def validate_export(blob: Any) -> List[str]:
    """Schema check for a registry JSON export.  Returns a list of
    problems, empty when the blob conforms."""
    problems: List[str] = []
    if not isinstance(blob, dict):
        return [f"metrics export is {type(blob).__name__}, not a dict"]
    if blob.get("schema") != EXPORT_SCHEMA:
        problems.append(f"schema tag {blob.get('schema')!r} != "
                        f"{EXPORT_SCHEMA!r}")
    for kind in ("counters", "gauges", "histograms"):
        sect = blob.get(kind)
        if sect is None:
            problems.append(f"missing section {kind!r}")
            continue
        if not isinstance(sect, dict):
            problems.append(f"section {kind!r} is not a dict")
            continue
        for key, val in sect.items():
            if kind == "histograms":
                if not isinstance(val, dict) or "count" not in val:
                    problems.append(f"histogram {key!r} lacks a count")
            elif not isinstance(val, (int, float)):
                problems.append(f"{kind[:-1]} {key!r} value {val!r} is "
                                f"not numeric")
    return problems


#: process-wide default registry (the one ``--metrics-out`` dumps).
REGISTRY = MetricsRegistry()


def export_engine_stats(engine, registry: Optional[MetricsRegistry] = None
                        ) -> MetricsRegistry:
    """Mirror a :class:`CollectiveEngine`'s cache counters into the
    registry as gauges (values are cumulative since engine creation --
    gauges, because ``clear_cache``/``calibrate`` can reset the
    underlying dict's semantics).  Uses the engine's atomic
    ``stats_snapshot()`` so the export is a consistent view."""
    reg = registry if registry is not None else REGISTRY
    snap = engine.stats_snapshot()
    labels = {"fabric": engine.topology.name or engine.fabric.name}
    for key, val in snap.items():
        reg.gauge(f"engine_{key}", labels=labels,
                  help=f"CollectiveEngine {key} since engine creation"
                  ).set(val)
    return reg


def export_prefix_cache_stats(server,
                              registry: Optional[MetricsRegistry] = None
                              ) -> MetricsRegistry:
    """Mirror a serving ``ContinuousBatchingServer``'s prefix-cache and
    block-pool state into the registry: the live / evictable occupancy
    split (cache pressure vs true load) plus the cache's hit / insert /
    eviction counters.  No-cache servers export the pool gauges only."""
    reg = registry if registry is not None else REGISTRY
    alloc = server.allocator

    def g(name: str, value: float, help_: str) -> None:
        reg.gauge(name, help=help_).set(float(value))

    g("kv_pool_blocks_live", alloc.num_used,
      "KV blocks referenced by live requests (true load)")
    g("kv_pool_blocks_evictable", alloc.num_evictable,
      "refcount-0 cached KV blocks resident until pool pressure")
    g("kv_pool_blocks_free", alloc.num_free,
      "KV blocks holding no retained content")
    g("kv_pool_evictions", alloc.evictions,
      "cached KV blocks reclaimed under pool pressure")
    cache = getattr(server, "prefix_cache", None)
    if cache is not None:
        g("prefix_cache_entries", len(cache),
          "content keys resident in the prefix cache")
        g("prefix_cache_block_hits", cache.hits,
          "blocks served from the prefix cache")
        g("prefix_cache_block_misses", cache.misses,
          "chain lookups that ended a prefix match")
        g("prefix_cache_inserts", cache.inserts,
          "blocks registered in the prefix cache")
    return reg


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "EXPORT_SCHEMA", "validate_export", "export_engine_stats",
           "export_prefix_cache_stats"]
