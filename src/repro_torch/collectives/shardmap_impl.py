"""The paper's Reduce/AllReduce algorithms as per-rank PyTorch programs.

The port of ``repro/collectives/shardmap_impl.py`` over one axis: each
function runs on every rank of a :class:`~repro_torch.collectives.comm.Comm`
(the counterpart of a ``shard_map`` axis binding), built from
``comm.ppermute`` rounds (one wavelet hop of the paper; ICI and NVLink
have no multicast, so Broadcast is log-depth doubling and the paper's
pipelining maps to chunked schedules).

Every add is the reference's: the same operands in the same order, in
the input dtype, one hop at a time, so float32 results are bitwise equal
to the JAX package's.  Where the reference selects with
``jnp.where(idx == ...)`` the port branches on the Python rank, which
gives the same sum.  Non-root ranks of a reduce keep the reference's
leftover partials.  The 2D functions (Sec. 7) run on a
:class:`~repro_torch.collectives.comm.GridComm`, whose ``sub(axis)``
comms are the rows and columns a ``shard_map`` mesh binds.

The fused matmul + ring reduce-scatter (``fused_matmul_rs``, the port of
the ring in ``repro/kernels/fused_matmul_rs.py``) lives here too: it is
an algorithm over a ``Comm`` whose block GEMMs are the hand-written
``ops.matmul_tiled``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.collectives.comm import Comm, GridComm
from repro_torch.kernels import ops

Rounds = Sequence[Sequence[Tuple[int, int]]]


def _right(p: int) -> List[Tuple[int, int]]:
    return [(i, (i + 1) % p) for i in range(p)]


def _split(x: torch.Tensor, p: int) -> List[torch.Tensor]:
    n = x.shape[0]
    if n % p:
        raise ValueError(f"leading dim {n} is not divisible by {p}")
    return list(x.reshape((p, n // p) + tuple(x.shape[1:])).unbind(0))


def _need_power_of_two(name: str, p: int) -> None:
    if p & (p - 1):
        raise ValueError(f"{name} needs a power-of-two axis, got {p}")


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)


# ---------------------------------------------------------------------- #
# fixed patterns (Sec. 5) -- reduce to rank 0 of the axis
# ---------------------------------------------------------------------- #
def chain_reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Pipelined chain: rank i receives i+1's partial, adds, passes on.
    P-1 ppermute steps; the result lands on rank 0 (others hold
    partials, as on the WSE)."""
    p, idx = comm.size, comm.rank
    acc = x
    for t in range(p - 1):
        # rank (p-1-t) has a complete suffix partial; send left
        src = p - 1 - t
        shifted = comm.ppermute(acc, [(src, src - 1)])
        if idx == src - 1:
            acc = acc + shifted
    return acc


def tree_reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Recursive halving (Sec. 5.3): log2 P rounds of pairwise sends."""
    p, idx = comm.size, comm.rank
    _need_power_of_two("tree_reduce", p)
    acc = x
    step = 1
    while step < p:
        pairs = [(s + step, s) for s in range(0, p, 2 * step)]
        shifted = comm.ppermute(acc, pairs)
        if idx % (2 * step) == 0:
            acc = acc + shifted
        step *= 2
    return acc


def two_phase_reduce(x: torch.Tensor, comm: Comm,
                     group: Optional[int] = None) -> torch.Tensor:
    """Two-Phase (Sec. 5.4): chain within groups of S, then chain over the
    group leaders."""
    p, idx = comm.size, comm.rank
    if group is None:
        group = max(1, round(p ** 0.5))
    group = min(group, p)
    n_groups = -(-p // group)
    acc = x

    # phase 1: chain within each group towards its leader (g*group)
    for t in range(group - 1):
        pairs = []
        for g in range(n_groups):
            src = g * group + (group - 1 - t)
            if src < p and src > g * group:
                pairs.append((src, src - 1))
        if not pairs:
            continue
        shifted = comm.ppermute(acc, pairs)
        if idx in {d for _, d in pairs}:
            acc = acc + shifted

    # phase 2: chain over leaders
    for t in range(n_groups - 1):
        src = (n_groups - 1 - t) * group
        dst = src - group
        shifted = comm.ppermute(acc, [(src, dst)])
        if idx == dst:
            acc = acc + shifted
    return acc


def star_reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Star (Sec. 5.1): everyone sends to the root, one sender per round
    (the root's injection bandwidth is the contention term)."""
    p, idx = comm.size, comm.rank
    acc = x
    for t in range(p - 1):
        shifted = comm.ppermute(x, [(t + 1, 0)])
        if idx == 0:
            acc = acc + shifted
    return acc


def broadcast(x: torch.Tensor, comm: Comm, root: int = 0) -> torch.Tensor:
    """Log-depth doubling broadcast (no multicast on the fabric)."""
    p, idx = comm.size, comm.rank
    acc = x if idx == root else torch.zeros_like(x)
    step = 1
    while step < p:
        pairs = [((root + s) % p, (root + s + step) % p)
                 for s in range(step)]
        shifted = comm.ppermute(acc, pairs)
        offset = (idx - root) % p
        if step <= offset < 2 * step:
            acc = shifted
        step *= 2
    return acc


def chain_broadcast(x: torch.Tensor, comm: Comm, root: int = 0
                    ) -> torch.Tensor:
    """Linear-pipeline broadcast: root passes down the line, P-1 hops."""
    p, idx = comm.size, comm.rank
    acc = x if idx == root else torch.zeros_like(x)
    for t in range(p - 1):
        src = (root + t) % p
        dst = (root + t + 1) % p
        shifted = comm.ppermute(acc, [(src, dst)])
        if idx == dst:
            acc = shifted
    return acc


# ---------------------------------------------------------------------- #
# ReduceScatter / AllGather (Sec. 6.2 halves, exposed as first-class ops)
# ---------------------------------------------------------------------- #
def reduce_scatter_ring(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Ring reduce-scatter: rank i ends with the full sum of chunk i
    (``lax.psum_scatter(..., tiled=True)`` semantics).  Leading dim must
    be divisible by P."""
    p, idx = comm.size, comm.rank
    ch = _split(x, p)
    right = _right(p)
    for t in range(p - 1):
        recv = comm.ppermute(ch[(idx - 1 - t) % p], right)
        recv_idx = (idx - 2 - t) % p
        ch[recv_idx] = ch[recv_idx] + recv
    return ch[idx]


def allgather_ring(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Ring all-gather: out[i*m:(i+1)*m] holds rank i's shard
    (``lax.all_gather(..., tiled=True)`` semantics)."""
    p, idx = comm.size, comm.rank
    ch: List[Optional[torch.Tensor]] = [None] * p
    ch[idx] = x
    right = _right(p)
    for t in range(p - 1):
        ch[(idx - t - 1) % p] = comm.ppermute(ch[(idx - t) % p], right)
    return torch.cat(ch, dim=0)


def allgather_doubling(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Recursive-doubling all-gather: log2 P rounds, round k exchanging
    the 2^k-shard block each rank owns so far (wire total B*(P-1)/P per
    rank, what ``t_doubling_allgather`` prices).  P must be a power of
    two."""
    p, idx = comm.size, comm.rank
    _need_power_of_two("allgather_doubling", p)
    m = x.shape[0]
    out = x.new_zeros((p * m,) + tuple(x.shape[1:]))
    out[idx * m:(idx + 1) * m] = x
    step = 1
    while step < p:
        group = idx // step
        sent = out[group * step * m:(group + 1) * step * m]
        recv = comm.ppermute(sent, [(i, i ^ step) for i in range(p)])
        lo = (group ^ 1) * step * m
        out[lo:lo + step * m] = recv
        step *= 2
    return out


# ---------------------------------------------------------------------- #
# AllToAll (personalized exchange): ``lax.all_to_all(x, axis,
# split_axis=0, concat_axis=0, tiled=True)`` semantics -- x is [P*m, ...]
# with destination-major leading chunks; the output's chunk j is rank
# j's chunk for this rank (source-major).
# ---------------------------------------------------------------------- #
def all_to_all_ring(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Pairwise-exchange (shift) all-to-all: P-1 rounds; round t ships
    the chunk destined t ranks away as one shift-by-t ppermute."""
    p, idx = comm.size, comm.rank
    chunks = _split(x, p)
    out = list(chunks)              # slot idx: own chunk stays local
    for t in range(1, p):
        out[(idx - t) % p] = comm.ppermute(
            chunks[(idx + t) % p], [(i, (i + t) % p) for i in range(p)])
    return torch.cat(out, dim=0)


def all_to_all_bruck(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Bruck recursive-halving all-to-all: ceil(log2 P) rounds, round k
    shipping every chunk whose (rotated) slot index has bit k set a
    2^k-rank shift; the final gather restores source-major order."""
    p, idx = comm.size, comm.rank
    chunks = _split(x, p)
    rot = [chunks[(idx + j) % p] for j in range(p)]
    k = 0
    while (1 << k) < p:
        shift = 1 << k
        slots = [j for j in range(p) if (j >> k) & 1]
        sent = torch.stack([rot[j] for j in slots])
        recv = comm.ppermute(sent, [(i, (i + shift) % p) for i in range(p)])
        for j, r in zip(slots, recv.unbind(0)):
            rot[j] = r
        k += 1
    # slot j now holds the block from source (idx - j) mod P
    return torch.cat([rot[(idx - j) % p] for j in range(p)], dim=0)


# ---------------------------------------------------------------------- #
# ring AllReduce (Sec. 6.2): reduce-scatter + all-gather
# ---------------------------------------------------------------------- #
def ring_allreduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Classic ring (paper Fig. 7), chunked so each round moves B/P
    elements."""
    p, idx = comm.size, comm.rank
    n = x.shape[0]
    ch = _split(_pad_rows(x, (-n) % p), p)
    right = _right(p)

    # reduce-scatter: after P-1 rounds, rank i owns the full sum of
    # chunk (i+1) % p
    for t in range(p - 1):
        recv = comm.ppermute(ch[(idx - t) % p], right)
        recv_idx = (idx - t - 1) % p
        ch[recv_idx] = ch[recv_idx] + recv

    # all-gather: circulate the owned chunks
    for t in range(p - 1):
        ch[(idx - t) % p] = comm.ppermute(ch[(idx + 1 - t) % p], right)
    return torch.cat(ch, dim=0)[:n]


# ---------------------------------------------------------------------- #
# 2D collectives (Sec. 7) over a pair of a grid's axes: axes[0] is the
# outer (row-index, M rows) axis, axes[1] the inner (column-index, N
# columns) axis -- the folded m x n grid the paper's 2D lemmas price.
# ---------------------------------------------------------------------- #
REDUCE_FNS = {"chain": chain_reduce, "tree": tree_reduce,
              "two_phase": two_phase_reduce, "star": star_reduce}


def xy_reduce_2d(x: torch.Tensor, grid: GridComm, axes: Tuple[str, str],
                 patterns: Tuple[str, str] = ("chain", "chain")
                 ) -> torch.Tensor:
    """X-Y Reduce (Sec. 7.2): 1D reduce along every row (inner axis),
    then along column 0 (outer axis).  ``patterns`` names the 1D pattern
    per dimension, (outer, inner).  The result lands on rank (0, 0)."""
    x = REDUCE_FNS[patterns[1]](x, grid.sub(axes[1]))
    return REDUCE_FNS[patterns[0]](x, grid.sub(axes[0]))


def snake_reduce_2d(x: torch.Tensor, grid: GridComm,
                    axes: Tuple[str, str]) -> torch.Tensor:
    """Snake Reduce (Sec. 7.3): one pipelined chain over the
    boustrophedon order of the M x N grid, M*N - 1 unit hops.  The
    result lands on rank (0, 0) (snake rank 0).

    As under ``shard_map``, every hop runs in every row (or column) at
    once: each rank takes part in its row's (column's) ppermute, and
    only the rank at the hop's destination on both axes adds."""
    ay, ax = axes
    m, n = grid.axis_size(ay), grid.axis_size(ax)
    iy, ix = grid.axis_index(ay), grid.axis_index(ax)
    row, col = grid.sub(ax), grid.sub(ay)

    def pos(rank: int) -> Tuple[int, int]:
        y, k = divmod(rank, n)
        return (y, k if y % 2 == 0 else n - 1 - k)

    acc = x
    for t in range(m * n - 1):
        (ys, xs), (yd, xd) = pos(m * n - 1 - t), pos(m * n - 2 - t)
        if ys == yd:
            shifted = row.ppermute(acc, [(xs, xd)])
        else:
            shifted = col.ppermute(acc, [(ys, yd)])
        if ix == xd and iy == yd:
            acc = acc + shifted
    return acc


def broadcast_2d(x: torch.Tensor, grid: GridComm, axes: Tuple[str, str],
                 root: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """2D broadcast from ``root``: doubling down the root's column
    (outer axis), then along every row (no multicast)."""
    x = broadcast(x, grid.sub(axes[0]), root=root[0])
    return broadcast(x, grid.sub(axes[1]), root=root[1])


def xy_allreduce_2d(x: torch.Tensor, grid: GridComm, axes: Tuple[str, str],
                    patterns: Tuple[str, str] = ("chain", "chain")
                    ) -> torch.Tensor:
    """2D AllReduce as X-Y Reduce + 2D broadcast (Sec. 7.4)."""
    return broadcast_2d(xy_reduce_2d(x, grid, axes, patterns), grid, axes)


def snake_allreduce_2d(x: torch.Tensor, grid: GridComm,
                       axes: Tuple[str, str]) -> torch.Tensor:
    """2D AllReduce as Snake Reduce + 2D broadcast (Sec. 7.4)."""
    return broadcast_2d(snake_reduce_2d(x, grid, axes), grid, axes)


# ---------------------------------------------------------------------- #
# schedule-driven executor: runs any ReduceTree (Auto-Gen) as rounds of
# disjoint ppermutes (the paper's code generation, retargeted)
# ---------------------------------------------------------------------- #
def schedule_reduce(x: torch.Tensor, comm: Comm, rounds: Rounds
                    ) -> torch.Tensor:
    acc = x
    for sends in rounds:
        pairs = list(sends)
        shifted = comm.ppermute(acc, pairs)
        if comm.rank in {d for _, d in pairs}:
            acc = acc + shifted
    return acc


def schedule_reduce_pipelined(x: torch.Tensor, comm: Comm, rounds: Rounds,
                              n_chunks: int = 4) -> torch.Tensor:
    """The paper's *pipelining* at tile granularity: the vector is split
    into chunks and the round schedule is software-pipelined -- round r
    works on chunk c while round r+1 already moves chunk c-1, so a
    depth-D tree costs D + n_chunks - 1 ppermute waves of B/n_chunks
    bytes instead of D waves of B bytes."""
    n = x.shape[0]
    chunks = _split(_pad_rows(x, (-n) % n_chunks), n_chunks)
    n_rounds = len(rounds)
    # wavefront schedule: at wave w, chunk c undergoes round w - c
    for wave in range(n_rounds + n_chunks - 1):
        for c in range(n_chunks):
            r = wave - c
            if 0 <= r < n_rounds:
                pairs = list(rounds[r])
                shifted = comm.ppermute(chunks[c], pairs)
                if comm.rank in {d for _, d in pairs}:
                    chunks[c] = chunks[c] + shifted
    return torch.cat(chunks, dim=0)[:n]


def schedule_broadcast(x: torch.Tensor, comm: Comm, rounds: Rounds
                       ) -> torch.Tensor:
    """Run a ReduceTree schedule *in reverse* as a broadcast from the
    tree root: the reversed round list visits each edge parent-before-
    child, a valid multicast order."""
    acc = x
    for sends in reversed(list(rounds)):
        pairs = [(d, s) for s, d in sends]
        shifted = comm.ppermute(acc, pairs)
        if comm.rank in {d for _, d in pairs}:
            acc = shifted
    return acc


def _rotate_rounds(rounds: Rounds, p: int, shift: int
                   ) -> List[List[Tuple[int, int]]]:
    return [[((s + shift) % p, (d + shift) % p) for s, d in sends]
            for sends in rounds]


def schedule_reduce_scatter(x: torch.Tensor, comm: Comm, rounds: Rounds
                            ) -> torch.Tensor:
    """Auto-Gen reduce-scatter: chunk c runs the root-0 reduce schedule
    rotated by c, so its sum lands on rank c; every rank keeps its own
    chunk."""
    p = comm.size
    chunks = _split(x, p)
    mine = None
    for c in range(p):
        out = schedule_reduce(chunks[c], comm, _rotate_rounds(rounds, p, c))
        if c == comm.rank:
            mine = out
    return mine


def schedule_allgather(x: torch.Tensor, comm: Comm, rounds: Rounds
                       ) -> torch.Tensor:
    """Auto-Gen all-gather: chunk c is broadcast from rank c along the
    reversed reduce schedule rotated by c."""
    p = comm.size
    gathered = []
    for c in range(p):
        seeded = x if comm.rank == c else torch.zeros_like(x)
        gathered.append(schedule_broadcast(seeded, comm,
                                           _rotate_rounds(rounds, p, c)))
    return torch.cat(gathered, dim=0)


# ---------------------------------------------------------------------- #
# fused matmul + ring reduce-scatter.  Every rank holds x [M, K_loc] and
# w [K_loc, N]; the full product is sum_r x_r @ w_r and rank i needs only
# row block i of it.  Rank d, step t:
#     acc      <- gemm(x[rows of block (d+1) % P], w)          # t = 0
#     for t in 1..P-1:
#         acc  <- ppermute(acc, d -> d-1)                      # wire
#         acc  <- acc + gemm(x[rows of block (d+t+1) % P], w)  # x.dtype
# after which rank d holds sum_r partial_r[d], which is
# lax.psum_scatter(x @ w, axis, tiled=True).  The GEMMs run on PyTorch's
# current stream and NCCL on its own; the ring does not overlap them yet.
# ---------------------------------------------------------------------- #
def fused_matmul_rs(x: torch.Tensor, w: torch.Tensor, comm: Comm
                    ) -> torch.Tensor:
    """Fused ``reduce_scatter(x @ w)`` over the communicator's axis:
    ``[M, K_loc] @ [K_loc, N] -> [M/P, N]``, rank ``i`` holding row
    block ``i`` of the summed product.  M must be divisible by P.  Each
    rank launches P block GEMMs."""
    p = comm.size
    if p == 1:
        return ops.matmul_tiled(x, w)
    m = x.shape[0]
    if m % p:
        raise ValueError(f"fused_matmul_rs: {m} rows do not split into "
                         f"{p} ring blocks")
    mb = m // p
    idx = comm.rank
    down = [(i, (i - 1) % p) for i in range(p)]

    def block_gemm(t: int) -> torch.Tensor:
        start = ((idx + t + 1) % p) * mb
        return ops.matmul_tiled(x[start:start + mb], w)

    acc = block_gemm(0)
    for t in range(1, p):
        acc = comm.ppermute(acc, down)
        acc = acc + block_gemm(t)
    return acc


def matmul_then_rs(x: torch.Tensor, w: torch.Tensor, comm: Comm
                   ) -> torch.Tensor:
    """The gathered path: the full local GEMM (float32 accumulation,
    ``torch.matmul``, not a kernel in the reference either), then the
    native reduce-scatter.  The semantics of :func:`fused_matmul_rs`,
    with the GEMM and the wire serialized."""
    y = torch.matmul(x.float(), w.float()).to(x.dtype)
    if comm.size == 1:
        return y
    return comm.psum_scatter(y)


__all__ = [
    "REDUCE_FNS", "chain_reduce", "tree_reduce", "two_phase_reduce",
    "star_reduce", "broadcast", "chain_broadcast", "ring_allreduce",
    "reduce_scatter_ring", "allgather_ring", "allgather_doubling",
    "all_to_all_ring", "all_to_all_bruck",
    "xy_reduce_2d", "snake_reduce_2d", "broadcast_2d", "xy_allreduce_2d",
    "snake_allreduce_2d",
    "schedule_reduce", "schedule_reduce_pipelined", "schedule_broadcast",
    "schedule_reduce_scatter", "schedule_allgather", "fused_matmul_rs",
    "matmul_then_rs",
]
