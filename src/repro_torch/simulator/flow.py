"""Flow-level (stream) simulator for reduction schedules.

Execution semantics (paper Secs. 2.2, 5, Fig. 5/6):

* every message is a stream of B elements moving at 1 element/cycle;
* a stream from child c to parent v starts flowing once c has *started*
  producing its combined vector (pipelining), travels ``dist(c, v)`` hops
  (1 cycle/hop), descends the ramp (T_R), and is added at 1 element/cycle;
* a vertex receives its children strictly in order: child j's elements are
  only accepted after child j-1's stream has fully drained (the router's
  routing configuration serializes this; earlier wavelets stall);
* the *last* child's stream is pipelined through: the parent emits element
  m (after an add + up-ramp) as soon as element m is reduced.

These recurrences reproduce the closed forms up to O(1) cycles per hop;
the wavelet-level ``fabric`` simulator validates them from first
principles on small grids.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.model import Fabric, WSE2
from repro_torch.core.schedule import ReduceTree


@dataclasses.dataclass
class SimResult:
    cycles: float
    label: str = ""


def simulate_reduce_tree(tree: ReduceTree, b: int,
                         fabric: Fabric = WSE2) -> SimResult:
    """Simulate one reduction described by an ordered tree.

    Returns the cycle at which the root has finished accumulating the
    global sum.
    """
    t_r = fabric.t_r
    p = tree.num_pes
    if p == 1:
        return SimResult(0.0, tree.label)

    emit_first: List[Optional[float]] = [None] * p

    # children-before-parents order
    order = tree._topo_leaves_first()

    def arrival_first(c: int, v: int) -> float:
        # first element of c's stream is ready to be added at v
        assert emit_first[c] is not None
        return emit_first[c] + tree.hop_distance(c, v) + t_r

    recv_done: List[float] = [0.0] * p
    for v in order:
        ch = tree.children[v]
        if not ch:
            emit_first[v] = t_r  # leaf: first element up the ramp
            continue
        done = 0.0
        for c in ch[:-1]:
            done = max(done, arrival_first(c, v)) + b
        last = ch[-1]
        first_ready = max(done, arrival_first(last, v))
        recv_done[v] = first_ready + b
        # pipelined emit towards v's parent: add(1) + up-ramp(T_R)
        emit_first[v] = first_ready + fabric.store_cost + t_r
    return SimResult(recv_done[tree.root], tree.label)


def simulate_broadcast(p: int, b: int, fabric: Fabric = WSE2,
                       distance: Optional[int] = None) -> SimResult:
    """Flooding broadcast: root streams B elements; multicast duplicates at
    every router for free; completion when the farthest PE stored the last
    element.  T = T_R + (B - 1) + dist + T_R + 1."""
    if p == 1:
        return SimResult(0.0, "bcast")
    if distance is None:
        distance = p - 1
    cycles = fabric.t_r + (b - 1) + distance + fabric.t_r + fabric.store_cost
    return SimResult(cycles, "bcast")


def simulate_broadcast_2d(m: int, n: int, b: int,
                          fabric: Fabric = WSE2) -> SimResult:
    return simulate_broadcast(m * n, b, fabric,
                              distance=(m - 1) + (n - 1))


def simulate_allreduce(tree: ReduceTree, b: int, fabric: Fabric = WSE2,
                       distance: Optional[int] = None) -> SimResult:
    """Reduce-then-Broadcast AllReduce over the same PE set."""
    red = simulate_reduce_tree(tree, b, fabric)
    if distance is None:
        # broadcast from the root back across the same extent
        if tree.positions is None:
            distance = tree.num_pes - 1
        else:
            distance = max(tree.hop_distance(tree.root, v)
                           for v in range(tree.num_pes))
    bc = simulate_broadcast(tree.num_pes, b, fabric, distance=distance)
    return SimResult(red.cycles + bc.cycles, f"{tree.label}+bcast")


def simulate_ring_allreduce(p: int, b: int, fabric: Fabric = WSE2) -> SimResult:
    """Round-based ring AllReduce (Sec. 6.2 mapping (a)).

    2(P-1) rounds; each round every PE sends a B/P chunk to its successor.
    The wrap-around edge travels P-1 hops; a round completes when the
    slowest edge drains (rounds are not pipelined against each other
    because round r+1's sends depend on round r's receives).
    """
    if p == 1:
        return SimResult(0.0, "ring")
    chunk = b / p
    per_round = chunk + (p - 1) + 2 * fabric.t_r + fabric.store_cost
    return SimResult(2 * (p - 1) * per_round, "ring")


def simulate_xy_reduce(tree_row: ReduceTree, tree_col: ReduceTree, b: int,
                       fabric: Fabric = WSE2) -> SimResult:
    """X-Y Reduce: all rows reduce in parallel, then column 0 reduces."""
    tx = simulate_reduce_tree(tree_row, b, fabric)
    ty = simulate_reduce_tree(tree_col, b, fabric)
    return SimResult(tx.cycles + ty.cycles,
                     f"xy({tree_row.label})")


def simulate_xy_allreduce(tree_row: ReduceTree, tree_col: ReduceTree, b: int,
                          m: int, n: int, fabric: Fabric = WSE2) -> SimResult:
    """2D AllReduce = X-Y Reduce + 2D flooding broadcast (Sec. 7.4)."""
    red = simulate_xy_reduce(tree_row, tree_col, b, fabric)
    bc = simulate_broadcast_2d(m, n, b, fabric)
    return SimResult(red.cycles + bc.cycles, f"{red.label}+bcast2d")


__all__ = [
    "SimResult", "simulate_reduce_tree", "simulate_broadcast",
    "simulate_broadcast_2d", "simulate_allreduce", "simulate_ring_allreduce",
    "simulate_xy_reduce", "simulate_xy_allreduce",
]
