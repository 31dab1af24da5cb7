"""Closed-form pattern costs from the paper (Lemmas 4.1, 5.1-5.4, 6.1, 7.1).

Every function returns the model estimate (Eq. 1) in cycles.  Functions are
deliberately kept in one-to-one correspondence with the paper's lemmas so
that the unit tests can assert our generic ``ReduceTree.cost_terms`` +
``CostTerms.cycles`` machinery reproduces each lemma exactly.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from repro_torch.core.model import CostTerms, Fabric, WSE2, ceil_div, log2i
from repro_torch.core import schedule as sched


# ---------------------------------------------------------------------- #
# 1D primitives
# ---------------------------------------------------------------------- #
def t_message(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Sending a B-vector across a row of P PEs: T = B + P + 2*T_R."""
    terms = CostTerms(depth=1, distance=p - 1, energy=b * (p - 1),
                      contention=b, links=max(p - 1, 1), label="message",
                      launches=1)
    return terms.cycles(fabric)


def t_broadcast(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Flooding broadcast == message (Lemma 4.1), thanks to multicast."""
    return t_message(p, b, fabric)


# ---------------------------------------------------------------------- #
# 1D Reduce patterns
# ---------------------------------------------------------------------- #
def t_star(p: int, b: int, fabric: Fabric = WSE2, refined: bool = True) -> float:
    """Star Reduce (Lemma 5.1).  ``refined`` uses the paper's closer look:
    the star forms a perfect pipeline at the root, so
    T = B*(P-1) + 2*T_R + 1 (no congestion term)."""
    if p == 1:
        return 0.0
    if refined:
        return (b * (p - 1) / fabric.link_bw + 2 * fabric.t_r
                + fabric.store_cost + fabric.t_launch * (p - 1))
    terms = CostTerms(depth=1, distance=p - 1,
                      energy=b * p * (p - 1) / 2.0,
                      contention=b * (p - 1), links=p - 1, label="star",
                      launches=p - 1)
    return terms.cycles(fabric)


def t_chain(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Chain Reduce (Lemma 5.2): T = B + (2*T_R + 2)(P - 1)."""
    if p == 1:
        return 0.0
    return (b / fabric.link_bw + fabric.hop_pipeline_cost * (p - 1)
            + fabric.t_launch * (p - 1))


def t_tree(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Binary-tree Reduce (Lemma 5.3), P a power of two."""
    if p == 1:
        return 0.0
    lg = log2i(p)
    bw = fabric.link_bw
    bandwidth = b * p / (2.0 * (p - 1)) * lg / bw + (p - 1)
    return (max(b * lg / bw, bandwidth) + fabric.per_depth_cost * lg
            + fabric.t_launch * lg)


def t_two_phase(p: int, b: int, fabric: Fabric = WSE2,
                s: Optional[int] = None) -> float:
    """Two-Phase Reduce (Lemma 5.4).  With S = sqrt(P) (P = S^2):
    T <= max(2B, 2B - 2B/sqrt(P) + P) + (2*sqrt(P) - 2)(2*T_R + 1).
    For general S we evaluate the cost terms directly (same derivation)."""
    if p == 1:
        return 0.0
    if s is None:
        s = max(1, round(math.sqrt(p)))
    s = min(s, p)
    g = ceil_div(p, s)
    depth = (s - 1) + (g - 1)
    energy = (s - 1) * b * g + s * b * (g - 1)
    contention = 2 * b if (g > 1 and s > 1) else b
    terms = CostTerms(depth=depth, distance=p - 1, energy=energy,
                      contention=contention, links=p,
                      label=f"two_phase(S={s})", launches=depth)
    return terms.cycles(fabric)


def t_autogen_tree(tree: "sched.ReduceTree", b: int,
                   fabric: Fabric = WSE2) -> float:
    """Model cost of an arbitrary ordered reduction tree (Sec. 5.5)."""
    return tree.cost_terms(b).cycles(fabric)


REDUCE_PATTERNS: Dict[str, Callable[[int, int, Fabric], float]] = {
    "star": t_star,
    "chain": t_chain,
    "tree": t_tree,
    "two_phase": t_two_phase,
}


# ---------------------------------------------------------------------- #
# 1D AllReduce patterns
# ---------------------------------------------------------------------- #
def t_reduce_then_broadcast(t_reduce: float, p: int, b: int,
                            fabric: Fabric = WSE2) -> float:
    """Naive AllReduce (Sec. 6.1): T = T_reduce + T_bcast.

    The broadcast term honors the fabric: flooding multicast on the WSE
    (Lemma 4.1), log-depth doubling where multicast is missing (ICI) --
    that is what the shard_map implementation actually executes."""
    if fabric.multicast:
        return t_reduce + t_broadcast(p, b, fabric)
    return t_reduce + t_doubling_broadcast(p, b, fabric)


def t_allreduce(pattern: str, p: int, b: int, fabric: Fabric = WSE2) -> float:
    if pattern == "ring":
        return t_ring_allreduce(p, b, fabric)
    if pattern == "oneshot":
        return t_oneshot_allreduce(p, b, fabric)
    return t_reduce_then_broadcast(
        REDUCE_PATTERNS[pattern](p, b, fabric), p, b, fabric)


def t_ring_allreduce(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Ring AllReduce mapped onto the mesh row (Lemma 6.1):
    T = 2(P-1)B/P + 4P - 6 + 2(P-1)(2*T_R + 1)."""
    if p == 1:
        return 0.0
    bw = fabric.link_bw
    contention = 2.0 * (p - 1) * b / p / bw
    # E/N with E = 2(P-1) rounds * links
    bandwidth = 2.0 * (p - 1) * b / p / bw
    distance = 2.0 * (2 * p - 3)
    depth = 2.0 * (p - 1)
    return (max(contention, bandwidth + distance)
            + fabric.per_depth_cost * depth
            + fabric.t_launch * depth)


ALLREDUCE_PATTERNS = ("star", "chain", "tree", "two_phase", "ring",
                      "oneshot")


# ---------------------------------------------------------------------- #
# ReduceScatter / AllGather / Broadcast variants (engine candidate sets).
# Costs model the shard_map implementations in collectives/shardmap_impl
# on a multicast-free fabric (ICI): broadcast is doubling or a serialized
# chain, ring halves are the two phases of Lemma 6.1.
# ---------------------------------------------------------------------- #
def t_ring_reduce_scatter(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """One ring half: P-1 rounds of B/P-element sends around the row."""
    if p == 1:
        return 0.0
    moved = (p - 1) * b / p / fabric.link_bw
    distance = float(2 * p - 3)
    return (moved + distance + fabric.per_depth_cost * (p - 1)
            + fabric.t_launch * (p - 1))


def t_ring_allgather(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Same wire traffic as the reduce-scatter half, minus nothing the
    model separates -- symmetric phase of Lemma 6.1."""
    return t_ring_reduce_scatter(p, b, fabric)


def t_doubling_allgather(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Recursive doubling: round k ships a 2^k*(B/P) block; log2 P
    launches."""
    if p == 1:
        return 0.0
    lg = math.ceil(math.log2(p))
    return (b * (p - 1) / p / fabric.link_bw + fabric.per_depth_cost * lg
            + fabric.t_launch * lg)


def t_doubling_broadcast(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Log-depth doubling of the full vector: each of the ceil(log2 P)
    rounds is a serialized B-element send (no multicast on ICI)."""
    if p == 1:
        return 0.0
    lg = math.ceil(math.log2(p))
    return (lg * b / fabric.link_bw + fabric.per_depth_cost * lg
            + fabric.t_launch * lg)


def t_chain_broadcast(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Unpipelined hop-by-hop relay: P-1 serialized B-element sends."""
    if p == 1:
        return 0.0
    return (p - 1) * (b / fabric.link_bw + fabric.per_depth_cost
                      + fabric.t_launch)


REDUCE_SCATTER_PATTERNS: Dict[str, Callable[[int, int, Fabric], float]] = {
    "ring": t_ring_reduce_scatter,
}


# ---------------------------------------------------------------------- #
# AllToAll (personalized exchange): every device holds B elements, B/P
# destined to each peer.  The op conserves bytes (no reduction), so the
# candidate frontier is injection-vs-launch count: the pairwise/ring
# exchange is injection-optimal (B*(P-1)/P per device) at P-1 launches,
# the Bruck recursive-halving ships ~B/2 per round but only needs
# ceil(log2 P) launches -- the small-B winner.  On the physical ring the
# shift-by-t round's messages travel min(t, P-t) hops, so per-link
# traffic sums to ~B*P/4: the ring-bisection term the planner's flat
# single-shot pays and the hierarchical 2-phase decomposition avoids.
# ---------------------------------------------------------------------- #
def _ring_hop_sum(p: int) -> int:
    """Total shortest-path hop distance of the P-1 shift rounds."""
    return sum(min(t, p - t) for t in range(1, p))


def t_ring_all_to_all(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Pairwise-exchange all-to-all on a ring: P-1 rounds; round t ships
    the B/P chunk destined t ranks away as one shift-by-t permutation."""
    if p <= 1:
        return 0.0
    bw = fabric.link_bw
    chunk = b / p
    contention = b * (p - 1) / p / bw          # injection per device
    bandwidth = chunk * _ring_hop_sum(p) / bw  # per-link element load
    distance = float(p - 1)                    # pipeline fill across rounds
    return (max(contention, bandwidth + distance)
            + fabric.per_depth_cost * (p - 1)
            + fabric.t_launch * (p - 1))


def t_halving_all_to_all(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Bruck recursive halving: round k ships every chunk whose slot has
    bit k set (~B/2 elements) a 2^k-rank shift; ceil(log2 P) launches
    total, trading ~log2(P)/2 x injected bytes for log-depth latency."""
    if p <= 1:
        return 0.0
    bw = fabric.link_bw
    chunk = b / p
    sent = 0.0        # elements injected per device, all rounds
    link_load = 0.0   # per-link element load (energy / P links)
    distance = 0.0
    rounds = 0
    shift = 1
    while shift < p:
        n_slots = sum(1 for j in range(p) if (j >> rounds) & 1)
        hop = min(shift, p - shift)
        sent += chunk * n_slots
        link_load += chunk * n_slots * hop
        distance += hop
        rounds += 1
        shift <<= 1
    return (max(sent / bw, link_load / bw + distance)
            + fabric.per_depth_cost * rounds
            + fabric.t_launch * rounds)


# ---------------------------------------------------------------------- #
# One-shot latency algorithms: the whole collective as a single program
# launch (lax.psum / lax.all_gather / lax.all_to_all over the -- possibly
# folded -- axis).  The wire story is a direct exchange with no
# store-and-forward reuse: the AllReduce blasts each device's full vector
# to every peer (K-way combine at the receiver), the AllGather/AllToAll
# unicast each chunk straight to its consumer, so per-link load carries
# the full shortest-path hop sum.  More bytes than the multi-round
# patterns at large B -- but depth 1 and one launch, which is the whole
# point below the crossover the selector computes from these forms.
# The distance term is P (>= M+N-1 for every 2D folding of P), keeping
# each form above the Lemma 7.2 / injection lower bounds the planner
# validates candidates against.
# ---------------------------------------------------------------------- #
def t_oneshot_allreduce(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Single-launch all-broadcast + local K-way reduce: every device
    absorbs (P-1)*B elements, one launch, depth 1."""
    if p == 1:
        return 0.0
    bw = fabric.link_bw
    contention = b * (p - 1) / bw
    bandwidth = b * _ring_hop_sum(p) / p / bw
    distance = float(p)
    return (max(contention, bandwidth + distance)
            + fabric.per_depth_cost + fabric.t_launch)


def t_oneshot_allgather(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Single-launch direct shard exchange (B = gathered size): each
    device unicasts its B/P shard to all P-1 peers in one program."""
    if p == 1:
        return 0.0
    bw = fabric.link_bw
    shard = b / p
    contention = b * (p - 1) / p / bw
    bandwidth = shard * _ring_hop_sum(p) / bw
    distance = float(p)
    return (max(contention, bandwidth + distance)
            + fabric.per_depth_cost + fabric.t_launch)


def t_oneshot_all_to_all(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Single-launch personalized exchange (B = per-device bytes): all
    P-1 destination chunks in flight at once, depth 1."""
    if p <= 1:
        return 0.0
    bw = fabric.link_bw
    chunk = b / p
    contention = b * (p - 1) / p / bw
    bandwidth = chunk * _ring_hop_sum(p) / bw
    distance = float(p)
    return (max(contention, bandwidth + distance)
            + fabric.per_depth_cost + fabric.t_launch)


#: program launches per (op, algorithm) at axis size P -- the L_i column
#: of the ``calibrate_launch`` least-squares design matrix.
def launch_count(op: str, algorithm: str, p: int) -> float:
    if p <= 1:
        return 0.0
    lg = math.ceil(math.log2(p))
    if algorithm == "oneshot":
        return 1.0
    if op == "allreduce":
        if algorithm == "ring":
            return float(2 * (p - 1))
        s = min(max(1, round(math.sqrt(p))), p)
        reduce_rounds = {"star": p - 1, "chain": p - 1, "tree": lg,
                         "two_phase": (s - 1) + (ceil_div(p, s) - 1),
                         }.get(algorithm, p - 1)
        return float(reduce_rounds + lg)     # + doubling broadcast half
    if op in ("reduce_scatter", "allgather", "all_to_all", "broadcast"):
        return float({"ring": p - 1, "doubling": lg, "halving": lg,
                      "chain": p - 1}.get(algorithm, p - 1))
    return float(p - 1)


#: nominal MXU throughput in MACs per model cycle: a v5e axis cycle is
#: ~11.4 ns (one 512-byte flit over a 45 GB/s link) and the chip peaks
#: near 1e14 MAC/s, so ~2^20 MACs fit in one cycle.  Only the *ratio*
#: of compute to wire time enters the fused-overlap decision.  A TPU
#: figure, kept so that the port's fused-ring decision matches the
#: reference's; it says nothing about an H100's tensor cores.
MXU_MACS_PER_CYCLE = float(1 << 20)


def t_matmul(m: int, k: int, n: int,
             macs_per_cycle: float = MXU_MACS_PER_CYCLE) -> float:
    """Model cycles for an [m, k] @ [k, n] GEMM at nominal MXU rate."""
    return float(m) * float(k) * float(n) / macs_per_cycle


def t_fused_matmul_rs(p: int, b: int, t_mm: float,
                      fabric: Fabric = WSE2) -> float:
    """Overlapped fused matmul + ring reduce-scatter (the chunk-pipelined
    wavefront closed form with C = P chunks over two disjoint resource
    classes, MXU vs wire).

    ``b`` is the full [M, N] partial product in elements, ``t_mm`` the
    cycles of the full local GEMM.  The ring computes one of the P row
    blocks per step (``t_mm / p`` MXU cycles) while the previous step's
    accumulator rotates downstream (one B/P-element hop); fill is one
    GEMM chunk, then P-1 beats of the slower class, then the last hop::

        T_fused = t_mm/P + (P-1) * max(t_mm/P, t_hop) + t_hop

    with ``t_hop = (B/P)/bw + per_depth_cost + t_launch`` -- the same
    per-hop price ``t_ring_reduce_scatter`` charges P-1 times.  Against
    the serialized ``t_mm + t_rs`` this wins exactly when a block GEMM
    outlasts a hop (compute long enough to hide the wire), which is the
    crossover the engine's pricing exposes."""
    t_mm = float(t_mm)
    if p <= 1:
        return t_mm
    t_hop = ((b / p) / fabric.link_bw + fabric.per_depth_cost
             + fabric.t_launch)
    return t_mm / p + (p - 1) * max(t_mm / p, t_hop) + t_hop


ALL_TO_ALL_PATTERNS: Dict[str, Callable[[int, int, Fabric], float]] = {
    "ring": t_ring_all_to_all,
    "halving": t_halving_all_to_all,
}

ALLGATHER_PATTERNS: Dict[str, Callable[[int, int, Fabric], float]] = {
    "ring": t_ring_allgather,
    "doubling": t_doubling_allgather,
    "oneshot": t_oneshot_allgather,
}

BROADCAST_PATTERNS: Dict[str, Callable[[int, int, Fabric], float]] = {
    "doubling": t_doubling_broadcast,
    "chain": t_chain_broadcast,
}


# ---------------------------------------------------------------------- #
# 2D collectives (Sec. 7); grid is M rows x N cols, root at (0, 0)
# ---------------------------------------------------------------------- #
def t_broadcast_2d(m: int, n: int, b: int, fabric: Fabric = WSE2) -> float:
    """Lemma 7.1: T = B + M + N - 2 + 2*T_R + 1."""
    p = m * n
    terms = CostTerms(depth=1, distance=(m - 1) + (n - 1),
                      energy=b * (p - 1), contention=b,
                      links=max(p - 1, 1), label="bcast2d")
    return terms.cycles(fabric)


def t_xy_reduce(pattern: str, m: int, n: int, b: int,
                fabric: Fabric = WSE2,
                fabric_m: Optional[Fabric] = None,
                fabric_n: Optional[Fabric] = None) -> float:
    """X-Y Reduce (Sec. 7.2): 1D reduce along rows, then along column 0.

    ``fabric_m`` / ``fabric_n`` price each grid dimension with its own
    (axis-local) constants on a heterogeneous topology; both default to
    ``fabric``."""
    fn = REDUCE_PATTERNS[pattern]
    return (fn(n, b, fabric_n or fabric) + fn(m, b, fabric_m or fabric))


def t_snake_reduce(m: int, n: int, b: int, fabric: Fabric = WSE2) -> float:
    """Snake Reduce (Sec. 7.3): chain over all M*N PEs, unit hops.  On a
    heterogeneous grid pass the slowest of the two axis fabrics -- the
    one chain crosses both link classes."""
    return t_chain(m * n, b, fabric)


def t_xy_allreduce(pattern: str, m: int, n: int, b: int,
                   fabric: Fabric = WSE2,
                   fabric_m: Optional[Fabric] = None,
                   fabric_n: Optional[Fabric] = None) -> float:
    """AllReduce on x then y (Sec. 7.4, first variant)."""
    return (t_allreduce(pattern, n, b, fabric_n or fabric)
            + t_allreduce(pattern, m, b, fabric_m or fabric))


def t_reduce_bcast_2d(pattern: str, m: int, n: int, b: int,
                      fabric: Fabric = WSE2) -> float:
    """AllReduce as 2D Reduce + 2D Broadcast (Sec. 7.4, second variant)."""
    if pattern == "snake":
        red = t_snake_reduce(m, n, b, fabric)
    else:
        red = t_xy_reduce(pattern, m, n, b, fabric)
    return red + t_broadcast_2d(m, n, b, fabric)


def t_lower_bound_2d(m: int, n: int, b: int, fabric: Fabric = WSE2) -> float:
    """Lemma 7.2: T >= max(B, B/8 + M + N - 1) + 2*T_R + 1, plus one
    program launch (any collective dispatches at least once).

    On a heterogeneous grid instantiate with a fabric no slower than any
    axis's (max link_bw, min latency) so the bound stays a bound."""
    bw = fabric.link_bw
    return (max(float(b) / bw, b / 8.0 / bw + m + n - 1)
            + fabric.per_depth_cost * 1.0 + fabric.t_launch * 1.0)


__all__ = [
    "t_message", "t_broadcast", "t_star", "t_chain", "t_tree",
    "t_two_phase", "t_autogen_tree", "t_reduce_then_broadcast",
    "t_allreduce", "t_ring_allreduce", "t_broadcast_2d", "t_xy_reduce",
    "t_snake_reduce", "t_xy_allreduce", "t_reduce_bcast_2d",
    "t_lower_bound_2d", "t_ring_reduce_scatter", "t_ring_allgather",
    "t_doubling_allgather", "t_doubling_broadcast", "t_chain_broadcast",
    "t_ring_all_to_all", "t_halving_all_to_all",
    "t_oneshot_allreduce", "t_oneshot_allgather", "t_oneshot_all_to_all",
    "launch_count", "t_matmul", "t_fused_matmul_rs",
    "MXU_MACS_PER_CYCLE",
    "REDUCE_PATTERNS", "ALLREDUCE_PATTERNS", "REDUCE_SCATTER_PATTERNS",
    "ALLGATHER_PATTERNS", "BROADCAST_PATTERNS", "ALL_TO_ALL_PATTERNS",
]
