"""Online predicted-vs-measured model-error monitoring.

The port of ``repro/obs/model_error.py`` (numpy only; its reports equal
the reference's for the same spans).  The paper's methodological claim
is that the cost model "predicts performance with less than 4% error";
this module turns it into a continuously monitored invariant: spans
stream in, get binned by ``(op, topology, bytes-decile)``, and each bin
tracks the rolling relative error of the model's prediction against
measured wall time.  A bin whose rolling error crosses the threshold
(default 4%, the paper's bound) raises a *drift* flag with the
recommendation to rerun ``engine.calibrate()`` -- the model stopped
describing the hardware.

Units.  Predictions are model cycles (the Fabric time base); measured
times are wall seconds.  The ratio between them is exactly what
``engine.calibrate()`` fits, so the monitor handles it the same way:
unless an explicit ``seconds_per_cycle`` is given, each bin *anchors*
its scale on the median measured/predicted ratio of its first
``min_samples`` observations, then scores later samples against that
anchor.

Ranks.  A port collective runs on every rank and each rank's span
carries its ``rank``; :meth:`ModelErrorMonitor.observe_spans` counts a
call once, from rank 0's span (spans without a rank, as the
reference's, all count).
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the paper's model-error bound (Sec. 8: "less than 4% error")
DEFAULT_THRESHOLD = 0.04

BinKey = Tuple[str, str, int]


def bytes_decile(nbytes: int) -> int:
    """Decimal-decade bucket of a payload size: ``decile(B) =
    floor(log10 B)`` (0 for sub-10-byte payloads).  Sizes within one
    decade share launch/bandwidth regime closely enough to share a
    calibration anchor."""
    return max(0, int(math.log10(max(int(nbytes), 1))))


@dataclasses.dataclass
class ErrorBin:
    """Rolling predicted-vs-measured state for one (op, topo, decile)."""

    op: str
    topo: str
    decile: int
    min_samples: int
    window: int
    threshold: float
    seconds_per_cycle: Optional[float] = None
    n: int = 0
    anchor: Optional[float] = None          # fitted seconds per cycle
    _warmup: List[float] = dataclasses.field(default_factory=list)
    rel_errs: Deque[float] = dataclasses.field(default_factory=deque)

    def observe(self, predicted: float, measured_s: float) -> None:
        if predicted <= 0.0 or measured_s <= 0.0:
            return
        self.n += 1
        scale = self.seconds_per_cycle
        if scale is None:
            if self.anchor is None:
                # anchoring phase: collect ratios until the bin has
                # enough samples to fit its own time base
                self._warmup.append(measured_s / predicted)
                if len(self._warmup) >= self.min_samples:
                    self.anchor = float(np.median(self._warmup))
                    self._warmup.clear()
                return
            scale = self.anchor
        err = abs(scale * predicted - measured_s) / measured_s
        self.rel_errs.append(err)
        while len(self.rel_errs) > self.window:
            self.rel_errs.popleft()

    @property
    def scored(self) -> int:
        """Samples scored against a scale (post-anchor)."""
        return len(self.rel_errs)

    @property
    def rolling_error(self) -> Optional[float]:
        if not self.rel_errs:
            return None
        return float(np.mean(self.rel_errs))

    @property
    def drifted(self) -> bool:
        """True once the rolling error exceeds the threshold with
        enough scored samples to mean it."""
        err = self.rolling_error
        return (err is not None and self.scored >= self.min_samples
                and err > self.threshold)

    def as_dict(self) -> Dict[str, Any]:
        return {"op": self.op, "topo": self.topo, "decile": self.decile,
                "bytes_range": f"[1e{self.decile}, 1e{self.decile + 1})",
                "n": self.n, "scored": self.scored,
                "anchor_s_per_cycle": (self.seconds_per_cycle
                                       if self.seconds_per_cycle is not None
                                       else self.anchor),
                "rolling_error": self.rolling_error,
                "threshold": self.threshold,
                "drifted": self.drifted}


class ModelErrorMonitor:
    """Aggregates spans into per-(op, topology, bytes-decile) bins and
    flags drift past ``threshold``.

    ``seconds_per_cycle``: pass the known model-cycle duration (e.g.
    from a calibration fit) to score every sample directly; leave
    ``None`` to let each bin self-anchor on its first ``min_samples``
    observations (see module docstring).
    """

    def __init__(self, threshold: float = DEFAULT_THRESHOLD,
                 min_samples: int = 8, window: int = 64,
                 seconds_per_cycle: Optional[float] = None):
        self.threshold = threshold
        self.min_samples = min_samples
        self.window = window
        self.seconds_per_cycle = seconds_per_cycle
        self.bins: Dict[BinKey, ErrorBin] = {}
        self.observed = 0
        self.skipped = 0

    # ------------------------------------------------------------------ #
    def observe(self, op: str, topo: str, nbytes: int,
                predicted: float, measured_s: float) -> None:
        key = (op, topo, bytes_decile(nbytes))
        b = self.bins.get(key)
        if b is None:
            b = ErrorBin(op=op, topo=topo, decile=key[2],
                         min_samples=self.min_samples, window=self.window,
                         threshold=self.threshold,
                         seconds_per_cycle=self.seconds_per_cycle)
            self.bins[key] = b
        b.observe(predicted, measured_s)
        self.observed += 1

    def observe_span(self, span) -> bool:
        """Feed one collective span; returns False when the span lacks
        a usable (predicted, measured) pair."""
        args = getattr(span, "args", span)
        pred = args.get("predicted")
        meas = args.get("measured_s")
        if pred is None or meas is None or pred <= 0 or meas <= 0:
            self.skipped += 1
            return False
        axes = args.get("axis_sizes") or args.get("axes") or ()
        topo = "x".join(str(s) for s in axes) if not isinstance(
            axes, str) else axes
        self.observe(str(args.get("op", "?")), topo,
                     int(args.get("bytes", 0)), float(pred), float(meas))
        return True

    def observe_spans(self, spans: Sequence[Any]) -> int:
        """Feed many spans (collective-category only, one call once:
        rank 0's span of a multi-rank call); returns how many were
        scored."""
        fed = 0
        for sp in spans:
            if getattr(sp, "cat", "collective") != "collective":
                continue
            if getattr(sp, "args", sp).get("rank", 0) != 0:
                continue
            fed += int(self.observe_span(sp))
        return fed

    # ------------------------------------------------------------------ #
    def drifted_bins(self) -> List[ErrorBin]:
        return [b for b in self.bins.values() if b.drifted]

    @property
    def should_recalibrate(self) -> bool:
        return bool(self.drifted_bins())

    def recommendation(self) -> Optional[str]:
        drifted = self.drifted_bins()
        if not drifted:
            return None
        worst = max(drifted, key=lambda b: b.rolling_error or 0.0)
        return (f"model error drifted past "
                f"{self.threshold * 100:.1f}% in {len(drifted)} bin(s) "
                f"(worst: {worst.op}/{worst.topo} decile {worst.decile} "
                f"at {(worst.rolling_error or 0) * 100:.1f}%) -- rerun "
                f"engine.calibrate() to refit the fabric constants")

    def report(self) -> Dict[str, Any]:
        return {
            "threshold": self.threshold,
            "observed": self.observed,
            "skipped": self.skipped,
            "bins": [self.bins[k].as_dict() for k in sorted(self.bins)],
            "drifted": len(self.drifted_bins()),
            "recommendation": self.recommendation(),
        }

    def render_table(self) -> str:
        """Per-collective error table (the ``obs_report.py`` output)."""
        header = (f"{'op':<16} {'topo':<10} {'bytes':<14} {'n':>5} "
                  f"{'scored':>6} {'rel_err':>8} {'drift':>6}")
        lines = [header, "-" * len(header)]
        for key in sorted(self.bins):
            b = self.bins[key]
            err = b.rolling_error
            err_s = f"{err * 100:7.2f}%" if err is not None else "   --  "
            lines.append(
                f"{b.op:<16} {b.topo:<10} "
                f"{'[1e%d,1e%d)' % (b.decile, b.decile + 1):<14} "
                f"{b.n:>5} {b.scored:>6} {err_s:>8} "
                f"{'DRIFT' if b.drifted else 'ok':>6}")
        if len(lines) == 2:
            lines.append("(no spans with predicted+measured pairs)")
        rec = self.recommendation()
        if rec:
            lines.append(f"!! {rec}")
        return "\n".join(lines)


__all__ = ["ModelErrorMonitor", "ErrorBin", "bytes_decile",
           "DEFAULT_THRESHOLD"]
