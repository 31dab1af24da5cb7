"""Wavelet-level cycle simulator of a 1D row of WSE routers + PEs.

Models, from first principles (paper Sec. 2.2):

* 1 wavelet per link per cycle (links are shared *bandwidth*);
* per-color router queues (virtual channels): a stalled stream does not
  block other colors -- each communication edge of a schedule gets its own
  color, mirroring the paper's multi-color implementations;
* ramp latency T_R between router and PE in each direction;
* the PE performs one add pipeline step per cycle; a small output queue
  (send-DSD queue) of capacity 2 exerts backpressure on the add pipeline;
* routers serialize receives: PE v accepts child j's stream only after
  child j-1's stream has fully drained (routing-configuration switches,
  Fig. 3); early wavelets stall in their color queue;
* internal vertices pipeline their last child: element m of the outgoing
  stream is emitted right after element m was added (Fig. 5).

Used to validate the flow-level simulator and the performance model on
small instances -- and it checks numerical correctness: the root's
accumulator must equal the exact sum of all PE vectors.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.model import Fabric, WSE2
from repro_torch.core.schedule import ReduceTree

_QUEUE_CAP = 2     # per-color router queue entries
_OUT_CAP = 2       # PE send-DSD queue entries


@dataclasses.dataclass
class Wavelet:
    edge: int          # edge id == child vertex id (doubles as its color)
    seq: int           # element index within the stream
    value: float
    moved_at: int = -1


@dataclasses.dataclass
class FabricResult:
    cycles: int
    root_sum: np.ndarray


class _PE:
    def __init__(self, vid: int, tree: ReduceTree, b: int, data: np.ndarray):
        self.vid = vid
        self.b = b
        self.acc = data.astype(np.float64).copy()
        self.children = tree.children[vid]
        self.recv_counts = {c: 0 for c in self.children}
        self.active_child = 0
        self.emitted = 0
        self.out_queue: Deque[Wavelet] = deque()
        self.parent = tree.parent[vid]
        self.pipelined_ready = b if not self.children else 0

    def current_child(self) -> Optional[int]:
        if self.active_child < len(self.children):
            return self.children[self.active_child]
        return None

    def accepts(self, edge: int) -> bool:
        return self.current_child() == edge

    def can_absorb(self) -> bool:
        if self.parent < 0:
            return True
        if (self.active_child == len(self.children) - 1
                and len(self.out_queue) >= _OUT_CAP):
            return False  # emit stall would stall the add pipeline
        return True

    def absorb(self, w: Wavelet) -> None:
        self.acc[w.seq] += w.value
        self.recv_counts[w.edge] += 1
        if (self.active_child == len(self.children) - 1
                and self.parent >= 0):
            self.pipelined_ready = self.recv_counts[w.edge]
        if self.recv_counts[w.edge] == self.b:
            self.active_child += 1

    def try_emit(self) -> None:
        if self.parent < 0 or self.emitted >= self.b:
            return
        if len(self.out_queue) >= _OUT_CAP:
            return
        if self.emitted < self.pipelined_ready:
            self.out_queue.append(
                Wavelet(self.vid, self.emitted,
                        float(self.acc[self.emitted])))
            self.emitted += 1


def simulate_reduce_fabric(tree: ReduceTree, b: int,
                           data: Optional[np.ndarray] = None,
                           fabric: Fabric = WSE2,
                           max_cycles: int = 10_000_000) -> FabricResult:
    """Cycle-level simulation of a 1D reduce tree (ids on a row; all edges
    towards lower ids / westward)."""
    p = tree.num_pes
    # keep t_r exact: calibrated fabrics carry non-integer ramp
    # latencies, and truncating silently mis-simulated them -- a ramp
    # exit is simply not ready until the first integer cycle >= t_r out
    t_r = float(fabric.t_r)
    if data is None:
        data = np.random.default_rng(0).standard_normal((p, b))
    expected = data.sum(axis=0)
    if p == 1:
        return FabricResult(0, data[0].astype(np.float64))

    for c, par in tree.edges():
        if par >= c:
            raise ValueError("fabric sim expects edges towards lower ids")

    pes = [_PE(v, tree, b, data[v]) for v in range(p)]
    dest = {c: par for c, par in tree.edges()}

    # rq[i][e]: router i's queue for color/edge e
    rq: List[Dict[int, Deque[Wavelet]]] = [dict() for _ in range(p)]
    ramp_down: List[Deque[Tuple[int, Wavelet]]] = [deque() for _ in range(p)]
    ramp_up: List[Deque[Tuple[int, Wavelet]]] = [deque() for _ in range(p)]
    rr: List[int] = [0] * p  # round-robin arbitration state per link

    def q(i: int, e: int) -> Deque[Wavelet]:
        if e not in rq[i]:
            rq[i][e] = deque()
        return rq[i][e]

    for cycle in range(1, max_cycles):
        # A. down-ramp delivery -> PE absorb (one add per cycle)
        for v in range(p):
            pe = pes[v]
            if ramp_down[v]:
                ready, w = ramp_down[v][0]
                if ready <= cycle and pe.can_absorb():
                    ramp_down[v].popleft()
                    pe.absorb(w)
            pe.try_emit()

        # B. PE out-queue -> up-ramp (one entry per cycle)
        for v in range(p):
            pe = pes[v]
            if pe.out_queue:
                w = pe.out_queue.popleft()
                ramp_up[v].append((cycle + t_r, w))

        # C. up-ramp exit -> own router's color queue
        for v in range(p):
            if ramp_up[v]:
                ready, w = ramp_up[v][0]
                if ready <= cycle and len(q(v, w.edge)) < _QUEUE_CAP:
                    ramp_up[v].popleft()
                    w.moved_at = cycle
                    q(v, w.edge).append(w)

        # D. westward link i -> i-1: one wavelet per link per cycle,
        #    round-robin over colors with head-of-line routability.
        for i in range(1, p):
            colors = sorted(rq[i].keys())
            if not colors:
                continue
            n = len(colors)
            moved = False
            for k in range(n):
                e = colors[(rr[i] + k) % n]
                dq = rq[i][e]
                if not dq or dq[0].moved_at >= cycle:
                    continue
                if dest[e] == i:
                    continue  # waiting for this router's ramp, not the link
                w = dq[0]
                at = i - 1
                if dest[w.edge] == at:
                    # enters destination router's queue (stalls there if the
                    # PE is not accepting yet)
                    if len(q(at, e)) < _QUEUE_CAP:
                        dq.popleft()
                        w.moved_at = cycle
                        q(at, e).append(w)
                        moved = True
                else:
                    if len(q(at, e)) < _QUEUE_CAP:
                        dq.popleft()
                        w.moved_at = cycle
                        q(at, e).append(w)
                        moved = True
                if moved:
                    rr[i] = (colors.index(e) + 1) % n
                    break

        # E. destination router -> down-ramp: one wavelet per router/cycle,
        #    only for the stream the PE currently accepts.
        for v in range(p):
            pe = pes[v]
            cur = pe.current_child()
            if cur is None:
                continue
            dq = rq[v].get(cur)
            if dq and dq[0].moved_at < cycle and dest[cur] == v:
                w = dq.popleft()
                ramp_down[v].append((cycle + t_r, w))

        root = pes[tree.root]
        if root.active_child == len(root.children):
            got = root.acc
            if not np.allclose(got, expected, rtol=1e-9, atol=1e-9):
                raise AssertionError("fabric reduce produced a wrong sum")
            return FabricResult(cycle, got)

    raise RuntimeError("fabric simulation did not converge (deadlock?)")


def simulate_broadcast_fabric(p: int, b: int, fabric: Fabric = WSE2
                              ) -> FabricResult:
    """Flooding broadcast from PE 0 eastward with free router multicast:
    element m leaves PE 0 at cycle m; completion when the farthest PE
    stored the last element.  Deterministic closed pipeline.  Fractional
    (calibrated) ramp latencies round up to the completing cycle."""
    t_r = float(fabric.t_r)
    last = (b - 1) + t_r + (p - 1) + t_r + 1
    return FabricResult(int(math.ceil(last)), np.arange(b, dtype=np.float64))


__all__ = ["simulate_reduce_fabric", "simulate_broadcast_fabric",
           "FabricResult", "Wavelet"]
