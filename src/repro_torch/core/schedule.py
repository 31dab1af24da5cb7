"""Schedule IR: ordered reduction trees (the paper's pre-order trees).

Every 1D Reduce pattern in the paper -- Star, Chain, Tree, Two-Phase, and
the Auto-Gen output -- is an instance of one IR: a rooted tree over PEs
0..P-1 in which every vertex receives the (partial) vectors of its children
*in order* and forwards its combined vector to its parent.  The paper's
execution semantics (Sec. 5.5, Fig. 6) are:

* a vertex fully receives each child's message before the next child's
  message is accepted (routing configurations serialize receives);
* the *last* child's stream is pipelined: element m of the parent's
  outgoing message departs once element m of the last child has been
  added (this is what makes Chain cost B + (2T_R+2)(P-1) instead of B*P);
* communication edges may not overlap/cross, which for pre-order trees is
  equivalent to every subtree owning a contiguous interval of PE indices.

The IR carries enough structure to (a) evaluate the spatial cost terms,
(b) drive the flow-level and wavelet-level simulators, and (c) be lowered
to a round-based ``ppermute`` program for TPU meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.model import CostTerms, is_power_of_two


Position = Tuple[int, int]


@dataclasses.dataclass
class ReduceTree:
    """Ordered reduction tree over PEs ``0..p-1`` (root receives the sum)."""

    parent: List[int]            # parent[v], -1 for the root
    children: List[List[int]]    # children in receive order
    root: int
    positions: Optional[List[Position]] = None  # defaults to 1D row layout
    label: str = ""

    # ------------------------------------------------------------------ #
    # basic structure
    # ------------------------------------------------------------------ #
    @property
    def num_pes(self) -> int:
        return len(self.parent)

    def position(self, v: int) -> Position:
        if self.positions is None:
            return (v, 0)
        return self.positions[v]

    def hop_distance(self, u: int, v: int) -> int:
        """Manhattan (X-Y routed) hop distance between two PEs."""
        (ux, uy), (vx, vy) = self.position(u), self.position(v)
        return abs(ux - vx) + abs(uy - vy)

    def edges(self) -> Iterator[Tuple[int, int]]:
        """Yield (child, parent) pairs."""
        for v, p in enumerate(self.parent):
            if p >= 0:
                yield (v, p)

    def subtree_sizes(self) -> List[int]:
        size = [1] * self.num_pes
        for v in self._topo_leaves_first():
            if self.parent[v] >= 0:
                size[self.parent[v]] += size[v]
        return size

    def _topo_leaves_first(self) -> List[int]:
        """Vertices ordered so that children precede parents."""
        order: List[int] = []
        stack = [self.root]
        while stack:
            v = stack.pop()
            order.append(v)
            stack.extend(self.children[v])
        order.reverse()
        return order

    # ------------------------------------------------------------------ #
    # validation (invariants used by the hypothesis property tests)
    # ------------------------------------------------------------------ #
    def validate(self, require_contiguous: bool = True) -> None:
        p = self.num_pes
        if p == 0:
            raise ValueError("empty tree")
        if self.parent[self.root] != -1:
            raise ValueError("root must have parent -1")
        roots = [v for v in range(p) if self.parent[v] == -1]
        if roots != [self.root]:
            raise ValueError(f"expected a single root {self.root}, got {roots}")
        # children/parent consistency
        seen = set()
        for v in range(p):
            for c in self.children[v]:
                if self.parent[c] != v:
                    raise ValueError(f"child {c} of {v} has parent {self.parent[c]}")
                if c in seen:
                    raise ValueError(f"vertex {c} appears as a child twice")
                seen.add(c)
        if len(seen) != p - 1:
            raise ValueError("not all non-root vertices are children")
        # connectivity
        if len(self._topo_leaves_first()) != p:
            raise ValueError("tree is not connected")
        if require_contiguous and self.positions is None:
            self._validate_contiguous()

    def _validate_contiguous(self) -> None:
        """Non-overlapping edges <=> every subtree is an index interval."""
        lo = list(range(self.num_pes))
        hi = list(range(self.num_pes))
        size = [1] * self.num_pes
        for v in self._topo_leaves_first():
            par = self.parent[v]
            if par >= 0:
                lo[par] = min(lo[par], lo[v])
                hi[par] = max(hi[par], hi[v])
                size[par] += size[v]
        for v in range(self.num_pes):
            if hi[v] - lo[v] + 1 != size[v]:
                raise ValueError(
                    f"subtree of {v} is not contiguous: [{lo[v]},{hi[v]}] size {size[v]}"
                )

    # ------------------------------------------------------------------ #
    # spatial cost terms (feeds the performance model, Eq. 1)
    # ------------------------------------------------------------------ #
    def cost_terms(self, b: int, links: Optional[float] = None) -> CostTerms:
        depth = [0] * self.num_pes
        path_hops = [0] * self.num_pes
        energy = 0.0
        stack = [self.root]
        while stack:
            v = stack.pop()
            for c in self.children[v]:
                d = self.hop_distance(c, v)
                energy += float(b) * d
                depth[c] = depth[v] + 1
                path_hops[c] = path_hops[v] + d
                stack.append(c)
        contention = float(b) * max(
            (len(ch) for ch in self.children), default=0
        )
        if links is None:
            links = float(max(self.num_pes - 1, 1))
        return CostTerms(
            depth=float(max(depth)),
            distance=float(max(path_hops)),
            energy=energy,
            contention=contention,
            links=float(links),
            label=self.label,
        )

    # ------------------------------------------------------------------ #
    # lowering to rounds of disjoint sends (for the TPU ppermute executor)
    # ------------------------------------------------------------------ #
    def to_rounds(self) -> List[List[Tuple[int, int]]]:
        """Rounds of (src, dst) pairs; within a round all dsts are distinct
        and all srcs are distinct, so one round == one masked ppermute+add.

        An edge fires after (a) its source finished receiving all of its own
        children and (b) the previous sibling edge (receive order!) fired.
        """
        fire: List[int] = [0] * self.num_pes  # round in which v's edge fires
        # compute in leaves-first order: fire[v] depends on children of v and
        # on previous siblings.
        done: List[int] = [0] * self.num_pes  # round after which v is reduced
        for v in self._topo_leaves_first():
            r = 0
            for c in self.children[v]:
                # child c's edge fires after c is fully reduced and after the
                # previous sibling's edge.
                f = max(done[c], r)
                fire[c] = f
                r = f + 1
            done[v] = r
        rounds: List[List[Tuple[int, int]]] = []
        for v, p in self.edges():
            r = fire[v]
            while len(rounds) <= r:
                rounds.append([])
            rounds[r].append((v, p))
        # drop the root's (nonexistent) edge; sanity: disjointness
        for r, sends in enumerate(rounds):
            dsts = [d for _, d in sends]
            srcs = [s for s, _ in sends]
            if len(set(dsts)) != len(dsts) or len(set(srcs)) != len(srcs):
                raise AssertionError(f"round {r} has colliding sends: {sends}")
        return rounds


# ---------------------------------------------------------------------- #
# fixed patterns as trees (root = PE 0, the leftmost PE)
# ---------------------------------------------------------------------- #
def star_tree(p: int) -> ReduceTree:
    """Every PE sends directly to the root (Sec. 5.1); receive order is by
    distance so nearer streams drain first."""
    parent = [-1] + [0] * (p - 1)
    children = [list(range(1, p))] + [[] for _ in range(p - 1)]
    return ReduceTree(parent, children, root=0, label="star")


def chain_tree(p: int) -> ReduceTree:
    """Pipelined chain (Sec. 5.2): i receives from i+1."""
    parent = [i - 1 for i in range(p)]
    children = [[i + 1] if i + 1 < p else [] for i in range(p)]
    return ReduceTree(parent, children, root=0, label="chain")


def binary_tree(p: int) -> ReduceTree:
    """Recursive-halving tree (Sec. 5.3); p must be a power of two."""
    if not is_power_of_two(p):
        raise ValueError(f"binary_tree needs a power-of-two P, got {p}")
    parent = [-1] * p
    children: List[List[int]] = [[] for _ in range(p)]
    step = 1
    while step < p:
        for v in range(0, p, 2 * step):
            u = v + step
            if u < p:
                parent[u] = v
                children[v].append(u)  # receive order == round order
        step *= 2
    return ReduceTree(parent, children, root=0, label="tree")


def two_phase_tree(p: int, s: Optional[int] = None) -> ReduceTree:
    """Two-Phase Reduce (Sec. 5.4): chain within groups of S, then a chain
    over the group leaders.  Default S = round(sqrt(P))."""
    if s is None:
        s = max(1, round(p ** 0.5))
    s = min(s, p)
    parent = [-1] * p
    children: List[List[int]] = [[] for _ in range(p)]
    leaders = list(range(0, p, s))
    # phase 1: chain within each group towards its leader
    for g in leaders:
        end = min(g + s, p)
        for v in range(g + 1, end):
            parent[v] = v - 1
            children[v - 1].append(v)
    # phase 2: chain over leaders; leader g receives its group first, then
    # the next leader (pipelined last child).
    for i in range(len(leaders) - 1):
        a, b_ = leaders[i], leaders[i + 1]
        parent[b_] = a
        children[a].append(b_)
    return ReduceTree(parent, children, root=0, label=f"two_phase(S={s})")


def snake_tree(m: int, n: int) -> ReduceTree:
    """2D Snake Reduce (Sec. 7.3): a chain over the boustrophedon order of
    an M x N grid; every hop has distance 1."""
    order: List[int] = []
    positions: List[Position] = []
    for y in range(m):
        xs = range(n) if y % 2 == 0 else range(n - 1, -1, -1)
        for x in xs:
            order.append(y * n + x)
    p = m * n
    # Re-index so that PE ids follow the snake (pre-order = snake order).
    positions = [(0, 0)] * p
    for rank, flat in enumerate(order):
        positions[rank] = (flat % n, flat // n)
    parent = [i - 1 for i in range(p)]
    children = [[i + 1] if i + 1 < p else [] for i in range(p)]
    return ReduceTree(parent, children, root=0, positions=positions,
                      label="snake")


PATTERN_BUILDERS: dict = {
    "star": star_tree,
    "chain": chain_tree,
    "tree": binary_tree,
    "two_phase": two_phase_tree,
}


__all__ = [
    "ReduceTree",
    "star_tree",
    "chain_tree",
    "binary_tree",
    "two_phase_tree",
    "snake_tree",
    "PATTERN_BUILDERS",
]
