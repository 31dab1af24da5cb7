"""Fault-tolerance utilities for 1000+-node deployments: the port's copy of
``repro/runtime/fault_tolerance.py`` (pure Python, the same names and
outputs).

Components (all host-side control-plane logic, unit-tested on CPU):

* ``HeartbeatMonitor``   -- declares hosts dead after a missed-beat window.
* ``StragglerDetector``  -- flags hosts whose rolling step time exceeds a
                            multiple of the fleet median (mitigation: the
                            launcher re-shards data away from them or
                            swaps in a hot spare).
* ``ElasticPlan``        -- given a failed-host set, proposes the largest
                            valid sub-mesh (shrinking the data axis, never
                            the model axis: TP groups are monolithic) plus
                            the checkpoint step to restore.
* ``PreemptionGuard``    -- SIGTERM-driven checkpoint-and-exit for the
                            train loop.

The data plane (collective restart) is torch.distributed's on real
deployments; these pieces provide the decisions and the restart
protocol around it.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[str, float] = {h: now for h in hosts}

    def beat(self, host: str) -> None:
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t > self.timeout]


class StragglerDetector:
    """Rolling per-host step-time statistics with median-multiple flagging."""

    def __init__(self, window: int = 16, threshold: float = 1.5):
        self.window = window
        self.threshold = threshold
        self.times: Dict[str, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, host: str, step_time_s: float) -> None:
        self.times[host].append(step_time_s)

    def _avg(self, host: str) -> Optional[float]:
        t = self.times[host]
        return sum(t) / len(t) if t else None

    def stragglers(self) -> List[Tuple[str, float]]:
        avgs = {h: a for h in self.times if (a := self._avg(h)) is not None}
        if len(avgs) < 2:
            return []
        vals = sorted(avgs.values())
        median = vals[len(vals) // 2]
        if median <= 0:
            return []
        return [(h, a / median) for h, a in sorted(avgs.items())
                if a > self.threshold * median]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_mesh: Tuple[int, ...]
    new_mesh: Tuple[int, ...]
    restore_step: Optional[int]
    dropped_hosts: Tuple[str, ...]

    @property
    def shrink_factor(self) -> float:
        old = 1
        for d in self.old_mesh:
            old *= d
        new = 1
        for d in self.new_mesh:
            new *= d
        return new / old


def plan_elastic_remesh(mesh_shape: Tuple[int, ...],
                        axis_names: Tuple[str, ...],
                        hosts_per_slice: int,
                        failed_hosts: Set[str],
                        all_hosts: Sequence[str],
                        restore_step: Optional[int]) -> ElasticPlan:
    """Shrink the data axis to the largest power-of-two slice count that
    excludes failed hosts.  The model axis is preserved: a TP group with a
    dead member is dropped wholesale (its healthy members become spares).
    """
    assert "data" in axis_names
    data_idx = axis_names.index("data")
    healthy = [h for h in all_hosts if h not in failed_hosts]
    usable_slices = len(healthy) // max(hosts_per_slice, 1)
    new_data = 1
    while new_data * 2 <= min(mesh_shape[data_idx], usable_slices):
        new_data *= 2
    new_shape = list(mesh_shape)
    new_shape[data_idx] = new_data
    return ElasticPlan(tuple(mesh_shape), tuple(new_shape), restore_step,
                       tuple(sorted(failed_hosts)))


class PreemptionGuard:
    """SIGTERM -> set flag; the train loop checks ``should_stop`` each step
    and checkpoints before exiting (preemption-safe training)."""

    def __init__(self, install: bool = True):
        self._stop = threading.Event()
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not the main thread (tests)

    def _handler(self, signum, frame) -> None:
        self._stop.set()

    def request_stop(self) -> None:
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


__all__ = ["HeartbeatMonitor", "StragglerDetector", "ElasticPlan",
           "plan_elastic_remesh", "PreemptionGuard"]
