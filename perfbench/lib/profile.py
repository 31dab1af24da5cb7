"""The traced window: ``torch.profiler`` over the window, reduced to what
the per-layer metrics and the ``breakdown`` read.

The window is marked by a ``record_function`` range of its own
(``perfbench.window``), so the device's events and the host's share one
clock.  Device events are kernels, copies and fills; the device is busy
where any of them runs (the union of their intervals), idle elsewhere.
An idle gap is named by what the host was doing in it: the innermost
host range (a PyTorch operation, or a range the drivers mark around
their calls into the program) that covers the gap's midpoint.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW = "perfbench.window"
#: how many of the longest idle gaps are named for the breakdown
NAMED_GAPS = 400
TOP = 10

Interval = Tuple[int, int, str]       # (start ns, end ns, name)


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Interval]            # sorted by start, clipped to window
    host: List[Interval]              # sorted by start
    marks: List[Interval]             # the drivers' perfbench.* ranges

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        busy, cur_s, cur_e = 0, None, None
        for s, e, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy * 1e-9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, cur = [], self.window[0]
        for s, e, _ in self.device:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.window[1] > cur:
            gaps.append((cur, self.window[1]))
        return gaps

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device:
            out[name] += (e - s) * 1e-9
        return out

    def launches(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for _, _, name in self.device:
            out[name] += 1
        return out

    def host_at(self, t: int, starts: List[int]) -> str:
        """The innermost host range covering ``t`` (the window's own
        range left out): an operation among the few thousand that
        started last before ``t``, else one of the drivers' marks."""
        i = bisect.bisect_right(starts, t)
        best: Optional[Interval] = None
        for s, e, name in self.host[max(0, i - 4000):i]:
            if e >= t and name != WINDOW and (
                    best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        if best is None:
            for s, e, name in self.marks:
                if s <= t <= e and (best is None
                                    or e - s < best[1] - best[0]):
                    best = (s, e, name)
        return best[2] if best else "(no host range)"

    def breakdown(self) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        named: Dict[str, float] = defaultdict(float)
        starts = [h[0] for h in self.host]
        for a, b in gaps[:NAMED_GAPS]:
            named[self.host_at((a + b) // 2, starts)] += (b - a) * 1e-9
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in idle]}

    def summary(self) -> dict:
        """What the per-layer metrics and the result line read."""
        launches = self.launches()
        return {"busy_s": self.busy_s(), "window_s": self.window_s,
                "kernels": {n: [s, launches[n]]
                            for n, s in self.by_name().items()},
                "breakdown": self.breakdown()}


def reduce_events(events) -> Trace:
    """A ``Trace`` from the profiler's raw events (``_KinetoEvent``:
    ``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()``)."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # a host range is mirrored on the device's timeline as a
            # user annotation: not an operation
            if not ev.is_user_annotation() and \
                    not name.startswith("perfbench."):
                device.append((s, e, name))
        else:
            if name == WINDOW:
                window = (s, e)
            host.append((s, e, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    device = sorted((max(s, window[0]), min(e, window[1]), n)
                    for s, e, n in device
                    if e > window[0] and s < window[1])
    host.sort()
    marks = [h for h in host
             if h[2].startswith("perfbench.") and h[2] != WINDOW]
    return Trace(window, device, host, marks)


@contextlib.contextmanager
def traced(enabled: bool) -> Iterator[dict]:
    """Profile the body when ``enabled``; ``out["trace"]`` then holds the
    reduced ``Trace`` of the window, which the body marks with
    :func:`window_range`."""
    out: dict = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    out["trace"] = reduce_events(prof.profiler.kineto_results.events())


def window_range():
    from torch.profiler import record_function
    return record_function(WINDOW)


def mark(name: str):
    """A host range the drivers put around their calls into the
    program (``perfbench.<what>``), so that idle gaps can be named."""
    from torch.profiler import record_function
    return record_function(f"perfbench.{name}")


def kernel_time(summary: dict, match) -> Tuple[float, int]:
    """Device seconds and launches, in a trace summary, of the
    device operations whose name ``match`` accepts."""
    secs, n = 0.0, 0
    for name, (s, k) in summary["kernels"].items():
        if match(name):
            secs += s
            n += k
    return secs, n


def idle_share(summary: dict) -> float:
    """The device's idle share of the traced window in %."""
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
