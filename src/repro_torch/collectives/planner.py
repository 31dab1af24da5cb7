"""Topology-aware collective planner: joint multi-axis plans.

The port of ``repro/collectives/planner.py``.  It is framework-free
arithmetic over ``repro_torch.core`` (whose prices are bit-identical to
the reference's), so every plan, price and ``describe()`` string is the
reference's; a grid of ranks
(:class:`~repro_torch.collectives.comm.GridComm`) takes the place of a
mesh when the engine binds a plan to axis names.

The model layer already prices the paper's 2D results (xy-reduce,
snake-reduce, the 2D lower bound -- ``core/patterns.py`` Sec. 7) but the
runtime used to dispatch one axis at a time.  This module closes that
gap: ``plan_collective`` takes an *axis-size tuple* (the folded m x n
topology, e.g. ``("pod", "data") -> (2, 16)``) and jointly scores every
implemented multi-axis composition under Eq. (1):

* ``sequential``   -- per-axis AllReduce, innermost axis first (the old
  ``overlap.bucketed_allreduce`` loop).  Moves the full vector across
  every axis.
* ``hierarchical`` -- reduce-scatter(inner) -> allreduce(outer, on 1/P
  of the bytes) -> allgather(inner).  Bandwidth-optimal composition:
  the expensive outer (cross-pod) phase only ever sees ``B / P_inner``
  bytes.
* ``2d_xy``        -- the paper's X-Y Reduce over the folded m x n grid
  (best 1D pattern per dimension) plus a 2D broadcast (flooding where
  the fabric multicasts, per-axis doubling on ICI).
* ``2d_snake``     -- Snake Reduce: one pipelined chain over the
  boustrophedon order of the grid, plus the same 2D broadcast.
* ``flat``         -- the best 1D algorithm over the axes folded into a
  single logical axis (row-major), the ``psum((a, b))`` shape.
* ``latency``      -- the small-B latency regime: one single-shot
  program over the folded axis (depth 1, a single launch -- the
  ``t_oneshot_*`` closed forms).  Pays extra wire volume for minimal
  launch/depth overhead, so the model selects it exactly below the
  crossover where decode-sized payloads live.

Every multi-phase shape additionally grows a ``<shape>_pipelined``
candidate: the payload is sliced into ``n_chunks`` pieces and the
phases run as a wavefront, so a chunk's slow outer (cross-pod) phase
overlaps the next chunk's fast inner phase.  Phases are grouped into
*link classes* (the axes whose wires they occupy); only phases on
disjoint classes overlap, so the closed form is

    T_pipe(C) = sum_i t_i(B/C) + (C - 1) * max_class sum_cls t_i(B/C)

with the chunk count C chosen by the model from
:data:`PIPELINE_CHUNK_CANDIDATES`.  Per-phase launch overhead is inside
every chunk-sized ``t_i``, so small payloads fall back to the
serialized shapes on their own; ``cost_terms`` report the chosen
``n_chunks`` and the modeled ``overlap_saved`` vs the base shape.

Per-axis candidates inside each shape are priced through the engine's
``select`` (so their decisions share the persistent cache), the joint
winner is validated against the paper's 2D lower bound
(``t_lower_bound_2d``, Lemma 7.2), and the result is a
``CollectivePlan`` whose ``cost_terms`` expose the modeled per-axis
wire bytes -- the quantity that makes "hierarchical moves strictly
fewer cross-pod bytes" an assertable fact rather than folklore.

``reduce_scatter`` / ``allgather`` plans use the ``cascade`` shape
(per-axis halves, chunk-transposed so the output layout matches
``lax.psum_scatter(..., tiled=True)`` over the folded axes) and the
``flat`` shape; their lower bound takes the max over link classes of
Lemma 7.2's volume branch at the ``B * (p_ax-1)/P`` bytes that must
cross each axis's links (a bound that stays valid when phases on
disjoint axes overlap).

``all_to_all`` plans (the EP dispatch traffic class) use
``hierarchical`` (2-phase intra-pod/inter-pod: innermost axis first,
aggregating cross-pod traffic before it hits the slow links),
``sequential`` (outermost-first), and ``flat`` (single-shot over the
folded axis); every candidate validates against the per-axis injection
bound (``core.lowerbound.t_all_to_all_lower_bound`` maxed over link
classes -- again overlap-proof).

Plans are positional (axis *sizes*, not names) so the engine can cache
them under the topology signature ``(op, axis_sizes, bytes, fabric)``
and rebind grid axis names on retrieval.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import patterns as pat
from repro_torch.core.lowerbound import t_all_to_all_lower_bound
from repro_torch.core.model import Fabric, ceil_div, slowest_fabric
from repro_torch.core.selector import t_broadcast_2d_fabric

#: shapes a multi-axis allreduce plan may take
ALLREDUCE_SHAPES = ("sequential", "hierarchical", "2d_xy", "2d_snake",
                    "flat", "latency", "sequential_pipelined",
                    "hierarchical_pipelined")
#: shapes a multi-axis reduce_scatter / allgather plan may take
#: ("latency" is offered for allgather only: the latency regime has no
#: single-program reduce_scatter primitive distinct from the cascade)
SHARDED_SHAPES = ("cascade", "flat", "latency", "cascade_pipelined")
#: shapes a multi-axis all_to_all plan may take
ALL_TO_ALL_SHAPES = ("hierarchical", "sequential", "flat", "latency",
                     "hierarchical_pipelined", "sequential_pipelined")

#: chunk counts a ``*_pipelined`` candidate considers; the model keeps
#: the argmin (more chunks amortize the slow phase better, but every
#: chunk pays the full per-phase launch/depth overhead, so tiny payloads
#: price out of pipelining on their own)
PIPELINE_CHUNK_CANDIDATES = (2, 4, 8)

#: the engine's select() viewed from the planner:
#: (op, nbytes, p, topo=None, fabric=None) -- ``fabric`` carries the
#: axis-local constants of the axis the candidate actually traverses
SelectFn = Callable[..., Any]

AxisFabrics = Tuple[Fabric, ...]

#: per-phase ``(modeled time, link-class axis indices)`` -- the link
#: class identifies which axes' wires a phase occupies, so the pipelined
#: pricer knows which phases can genuinely overlap (disjoint classes)
#: and which serialize on shared links (same class)
PhaseList = List[Tuple[float, Tuple[int, ...]]]


def base_shape(shape: str) -> str:
    """``"hierarchical_pipelined" -> "hierarchical"``; serialized shapes
    map to themselves."""
    suffix = "_pipelined"
    return shape[:-len(suffix)] if shape.endswith(suffix) else shape


def _axis_fabrics(sizes: Sequence[int], fabric: Fabric,
                  axis_fabrics: Optional[Sequence[Optional[Fabric]]]
                  ) -> AxisFabrics:
    """Positional per-axis fabrics, defaulting every axis to ``fabric``
    (the uniform fast path hands back the same object everywhere)."""
    if axis_fabrics is None:
        return tuple(fabric for _ in sizes)
    if len(axis_fabrics) != len(sizes):
        raise ValueError(f"axis_fabrics {len(axis_fabrics)} entries for "
                         f"{len(sizes)} axes")
    return tuple(f if f is not None else fabric for f in axis_fabrics)


def _lb_fabric(fabrics: Sequence[Fabric]) -> Fabric:
    """A fabric no slower than any of ``fabrics`` on every constant, so
    Lemma 7.2 instantiated with it lower-bounds every candidate priced
    with the real per-axis constants.  Uniform input returns the shared
    object (bit-for-bit the single-fabric bound)."""
    f0 = fabrics[0]
    if all(f == f0 for f in fabrics[1:]):
        return f0
    return Fabric(name="lb",
                  t_r=min(f.t_r for f in fabrics),
                  store_cost=min(f.store_cost for f in fabrics),
                  link_bw=max(f.link_bw for f in fabrics),
                  multicast=any(f.multicast for f in fabrics))


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One executable phase of a plan.

    ``axes`` holds *indices* into the plan's axis tuple in positional
    (unbound) records and axis *names* once the engine binds a grid.
    ``nbytes`` is the vector size entering the phase (the size its
    algorithm was priced at).
    """

    kind: str                   # reduce_scatter | allreduce | allgather
                                # | xy_allreduce | snake_allreduce
    axes: Tuple[Any, ...]
    algorithm: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """A scored, executable multi-axis collective plan.

    ``predictions`` maps every candidate shape to its Eq.-(1) estimate;
    ``cost_terms`` maps every candidate shape to
    ``{"predicted": cycles, "axis_bytes": {axis: modeled wire bytes}}``
    where ``axis_bytes[ax]`` sums, over the shape's phases on that axis,
    ``phase_bytes * (p - 1) / p`` (doubled for allreduce phases, which
    run both a reduce-scatter-like and an allgather-like half).
    ``lower_bound`` is the overlap-aware bound the chosen plan was
    validated against.  ``n_chunks`` is how many payload slices the
    engine pipelines the phases over (1 for serialized shapes);
    ``*_pipelined`` entries in ``cost_terms`` additionally carry
    ``n_chunks`` and ``overlap_saved`` (modeled cycles recovered vs the
    phase-sequential base shape -- negative when pipelining would
    lose).
    """

    op: str
    axes: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    nbytes: int
    shape: str
    steps: Tuple[PlanStep, ...]
    predicted: float
    predictions: Dict[str, float]
    cost_terms: Dict[str, Dict[str, Any]]
    lower_bound: float
    n_chunks: int = 1

    def describe(self) -> str:
        """Compact human-readable plan shape, e.g.
        ``hierarchical(rs:ring->ar:ring->ag:ring)``."""
        if not self.steps:
            return "identity"
        inner = "->".join(
            f"{_KIND_ABBREV.get(s.kind, s.kind)}:{s.algorithm}"
            for s in self.steps)
        if self.n_chunks > 1:
            return f"{self.shape}({inner})[chunks={self.n_chunks}]"
        return f"{self.shape}({inner})"


_KIND_ABBREV = {"reduce_scatter": "rs", "allreduce": "ar",
                "allgather": "ag", "xy_allreduce": "xy",
                "snake_allreduce": "snake", "all_to_all": "a2a"}


def _elements(nbytes: int, element_bytes: int) -> int:
    return max(1, nbytes // element_bytes)


def _effective(sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """(axis index, size) for axes that actually move data."""
    return [(i, p) for i, p in enumerate(sizes) if p > 1]


def _fold_2d(sizes: Sequence[int]) -> Tuple[int, int]:
    """Fold an axis-size tuple into the m x n grid the 2D lemmas use:
    outer axes collapse into m, the innermost effective axis is n."""
    eff = _effective(sizes)
    if not eff:
        return (1, 1)
    if len(eff) == 1:
        return (1, eff[0][1])
    n = eff[-1][1]
    m = 1
    for _, p in eff[:-1]:
        m *= p
    return (m, n)


def _class_bound_fabric(ax_fab: Fabric, eff_fabs: Sequence[Fabric]
                        ) -> Fabric:
    """Constants for a per-link-class bound term: the class's own
    bandwidth (its wire volume cannot ride any other class's links) but
    latency constants no slower than any effective axis's, so the term
    stays below every candidate regardless of which axis's launch
    constants a phase happens to pay.  Uniform input returns the shared
    object (bit-for-bit the single-fabric term)."""
    if all(f == ax_fab for f in eff_fabs):
        return ax_fab
    return Fabric(name="lb_class",
                  t_r=min(f.t_r for f in eff_fabs),
                  store_cost=min(f.store_cost for f in eff_fabs),
                  link_bw=ax_fab.link_bw,
                  multicast=any(f.multicast for f in eff_fabs))


def lower_bound_multi(op: str, sizes: Sequence[int], nbytes: int,
                      fabric: Fabric, element_bytes: int,
                      axis_fabrics: Optional[Sequence[Fabric]] = None
                      ) -> float:
    """Overlap-aware lower bound for the folded topology and the op's
    minimal per-link-class volume.

    AllReduce carries full Lemma 7.2: the root must absorb the whole
    B-vector after it crossed the grid, so both the volume and the
    ``M + N - 1`` traversal branches bind -- a store-bandwidth argument
    that survives arbitrary phase overlap.  The other ops admit
    genuinely concurrent per-axis phases (disjoint link classes), so a
    serialized sum of per-axis terms is *not* a valid bound for them;
    instead each axis's links are bounded independently and the max
    taken:

    * ``all_to_all`` -- every device's ``B * (p_ax-1)/p_ax`` bytes
      destined for other ``ax``-slices must cross ``ax`` links
      (pre-aggregation cannot shrink a personalized exchange), so each
      axis carries the 1D injection bound at the full B.
    * ``reduce_scatter`` / ``allgather`` -- of the ``B``-sized result,
      the outputs owned by one ``ax``-slice need contributions from the
      other ``p_ax - 1`` slices; maximally pre-reduced that is still
      ``B * (p_ax-1) / P`` bytes into (out of) each device over ``ax``
      links -- Lemma 7.2's volume branch at that volume.

    Each per-class term is instantiated with that axis's bandwidth but
    latency constants no slower than any effective axis's
    (:func:`_class_bound_fabric`), so it stays below every
    per-axis-priced candidate, serialized or pipelined."""
    fabs = _axis_fabrics(tuple(sizes), fabric, axis_fabrics)
    m, n = _fold_2d(sizes)
    if m * n <= 1:
        return 0.0
    eff = _effective(sizes)
    eff_fabs = [fabs[i] for i, _ in eff]
    lbf = _lb_fabric(eff_fabs or [fabric])
    b = _elements(nbytes, element_bytes)
    if op == "all_to_all":
        return max(
            t_all_to_all_lower_bound(p_ax, b,
                                     _class_bound_fabric(fabs[i],
                                                         eff_fabs))
            for i, p_ax in eff)
    if op in ("reduce_scatter", "allgather"):
        p = m * n
        return max(
            pat.t_lower_bound_2d(
                1, 1, max(1, math.ceil(b * (p_ax - 1) / p)),
                _class_bound_fabric(fabs[i], eff_fabs))
            for i, p_ax in eff)
    return pat.t_lower_bound_2d(m, n, b, lbf)


def _best_reduce_pattern(p: int, b: int, fabric: Fabric
                         ) -> Tuple[str, float]:
    preds = {name: fn(p, b, fabric)
             for name, fn in pat.REDUCE_PATTERNS.items()
             if name != "tree" or (p & (p - 1)) == 0}
    name = min(preds, key=preds.get)
    return name, preds[name]


def _wire_bytes(nbytes: float, p: int, allreduce: bool = False) -> float:
    """Modeled per-device wire bytes of one phase over a P-way axis."""
    if p <= 1:
        return 0.0
    return (2.0 if allreduce else 1.0) * nbytes * (p - 1) / p


def _merge_bytes(into: Dict[int, float], frm: Dict[int, float]) -> None:
    for k, v in frm.items():
        into[k] = into.get(k, 0.0) + v


# ---------------------------------------------------------------------- #
# shape scoring
# ---------------------------------------------------------------------- #
ScoredShape = Tuple[float, List[PlanStep], Dict[int, float], PhaseList]


def _score_sequential(op_steps_kind: str, sizes: Sequence[int],
                      nbytes: int, select: SelectFn, fabs: AxisFabrics
                      ) -> ScoredShape:
    """Per-axis allreduce, innermost first (the legacy loop); each axis
    priced with its own fabric constants."""
    t = 0.0
    steps: List[PlanStep] = []
    axis_bytes: Dict[int, float] = {}
    phases: PhaseList = []
    for i in reversed(range(len(sizes))):
        p = sizes[i]
        if p <= 1:
            continue
        d = select("allreduce", nbytes, p, fabric=fabs[i])
        t += d.predicted
        steps.append(PlanStep("allreduce", (i,), d.algorithm, nbytes))
        axis_bytes[i] = _wire_bytes(nbytes, p, allreduce=True)
        phases.append((d.predicted, (i,)))
    return t, steps, axis_bytes, phases


def _score_cascade(op: str, sizes: Sequence[int], nbytes: int,
                   select: SelectFn, fabs: AxisFabrics
                   ) -> ScoredShape:
    """Per-axis reduce_scatter (innermost first) or allgather (outermost
    first); each phase shrinks/grows the live vector by its axis size."""
    t = 0.0
    steps: List[PlanStep] = []
    axis_bytes: Dict[int, float] = {}
    phases: PhaseList = []
    eff = _effective(sizes)
    order = list(reversed(eff)) if op == "reduce_scatter" else list(eff)
    if op == "allgather":
        # allgather phases grow from the shard: replay the shrink to
        # find per-phase entry sizes, then price in gather order
        cur = nbytes
        entry = {}
        for i, p in reversed(eff):
            entry[i] = cur
            cur = ceil_div(cur, p)
    for i, p in order:
        if op == "reduce_scatter":
            phase_bytes = nbytes
            nbytes = ceil_div(nbytes, p)
        else:
            phase_bytes = entry[i]
        d = select(op, phase_bytes, p, fabric=fabs[i])
        t += d.predicted
        steps.append(PlanStep(op, (i,), d.algorithm, phase_bytes))
        axis_bytes[i] = _wire_bytes(phase_bytes, p)
        phases.append((d.predicted, (i,)))
    return t, steps, axis_bytes, phases


def _score_flat(op: str, sizes: Sequence[int], nbytes: int,
                select: SelectFn, fabs: AxisFabrics
                ) -> ScoredShape:
    """Best 1D algorithm over the row-major-folded logical axis.  The
    decision is cached under the full topology signature, not the folded
    P, so a 16-way axis and a folded 2x8 never share entries.  The
    folded schedule may route any hop over any member axis, so it is
    priced with the slowest member fabric (conservative, and exactly
    why flat loses to hierarchical when pod links are slow)."""
    p = 1
    for s in sizes:
        p *= s
    eff_idx = tuple(i for i, _ in _effective(sizes))
    eff_fabs = [fabs[i] for i in eff_idx]
    slow = slowest_fabric(*(eff_fabs or [fabs[0]]))
    d = select(op, nbytes, p, topo=tuple(sizes), fabric=slow)
    kind = op if op != "allreduce" else "allreduce"
    steps = [PlanStep(kind, tuple(range(len(sizes))), d.algorithm, nbytes)]
    # conservative attribution: the folded schedule may route any hop
    # over any axis, so every axis is charged the full folded traffic
    axis_bytes = {i: _wire_bytes(nbytes, p, allreduce=op == "allreduce")
                  for i, s in enumerate(sizes) if s > 1}
    # one phase occupying every effective axis's links: nothing to
    # overlap, so flat never grows a pipelined variant
    return d.predicted, steps, axis_bytes, [(d.predicted, eff_idx)]


_ONESHOT_FORMS = {"allreduce": pat.t_oneshot_allreduce,
                  "allgather": pat.t_oneshot_allgather,
                  "all_to_all": pat.t_oneshot_all_to_all}


def _score_latency(op: str, sizes: Sequence[int], nbytes: int,
                   element_bytes: int, fabs: AxisFabrics
                   ) -> ScoredShape:
    """The small-B latency regime: one single-shot program over all
    effective axes folded into one logical axis -- depth 1, a single
    launch, no store-and-forward staging.  Priced by the ``t_oneshot_*``
    closed forms (``core/patterns.py``) at the slowest member fabric
    (the folded exchange may route any hop over any axis).  Pays more
    wire volume than the bandwidth-optimal shapes (no reuse of
    forwarded data), so it only wins below the crossover where
    per-phase launch/depth overhead dominates -- exactly the decode
    regime.  The engine dispatches it as one native collective on the
    joint axis tuple's sub-communicator (``allreduce_inside`` et al.,
    algorithm ``"oneshot"``)."""
    eff = _effective(sizes)
    p = 1
    for _, s in eff:
        p *= s
    eff_idx = tuple(i for i, _ in eff)
    slow = slowest_fabric(*(fabs[i] for i in eff_idx))
    b = _elements(nbytes, element_bytes)
    t = _ONESHOT_FORMS[op](p, b, slow)
    steps = [PlanStep(op, tuple(range(len(sizes))), "oneshot", nbytes)]
    if op == "allreduce":
        # all-broadcast + local K-way reduce: every device unicasts its
        # full vector to the p-1 others (no multicast reuse)
        per_axis = float(nbytes) * (p - 1)
    else:
        # allgather (nbytes = global result) / all_to_all (nbytes =
        # per-device shard): each device injects its (p-1)/p share once
        per_axis = _wire_bytes(float(nbytes), p)
    axis_bytes = {i: per_axis for i in eff_idx}
    # one phase occupying every effective axis's links: nothing to
    # overlap, so latency never grows a pipelined variant
    return t, steps, axis_bytes, [(t, eff_idx)]


def _score_hierarchical(sizes: Sequence[int], nbytes: int,
                        fabric: Fabric, element_bytes: int,
                        select: SelectFn, fabs: AxisFabrics
                        ) -> ScoredShape:
    """RS(inner) -> AR(outer, 1/P_inner bytes) -> AG(inner).  The RS and
    AG phases share the inner axis's links (one link class), the middle
    allreduce rides the outer axes -- the disjoint class a pipelined
    variant overlaps against."""
    eff = _effective(sizes)
    inner_i, inner_p = eff[-1]
    rs = select("reduce_scatter", nbytes, inner_p, fabric=fabs[inner_i])
    ag = select("allgather", nbytes, inner_p, fabric=fabs[inner_i])
    shard_nbytes = ceil_div(nbytes, inner_p)
    outer = [(i, p) for i, p in eff[:-1]]
    h_steps = [PlanStep("reduce_scatter", (inner_i,), rs.algorithm,
                        nbytes)]
    h_bytes: Dict[int, float] = {
        inner_i: _wire_bytes(nbytes, inner_p) * 2.0}
    if len(outer) == 1:
        oi, op_ = outer[0]
        ar = select("allreduce", shard_nbytes, op_, fabric=fabs[oi])
        h_steps.append(PlanStep("allreduce", (oi,), ar.algorithm,
                                shard_nbytes))
        t_mid = ar.predicted
        h_bytes[oi] = _wire_bytes(shard_nbytes, op_, allreduce=True)
    else:
        sub_sizes = tuple(sizes[i] if (i, sizes[i]) in outer else 1
                          for i in range(len(sizes)))
        sub = _plan_allreduce(sub_sizes, shard_nbytes, fabric,
                              element_bytes, select,
                              axis_fabrics=fabs)
        h_steps.append(PlanStep("allreduce",
                                tuple(i for i, _ in outer),
                                sub["shape"], shard_nbytes))
        t_mid = sub["predicted"]
        _merge_bytes(h_bytes,
                     {int(k): v for k, v in
                      sub["cost_terms"][sub["shape"]]
                      ["axis_bytes"].items()})
    h_steps.append(PlanStep("allgather", (inner_i,), ag.algorithm,
                            nbytes))
    phases: PhaseList = [(rs.predicted, (inner_i,)),
                         (t_mid, tuple(i for i, _ in outer)),
                         (ag.predicted, (inner_i,))]
    return (rs.predicted + t_mid + ag.predicted, h_steps, h_bytes,
            phases)


def _add_pipelined(shapes: Dict[str, Tuple[float, List[PlanStep],
                                           Dict[int, float]]],
                   extras: Dict[str, Dict[str, Any]], base: str,
                   nbytes: int, element_bytes: int,
                   score_chunk: Callable[[int], ScoredShape]) -> None:
    """Price the chunk-pipelined variant of an already-scored
    multi-phase shape and add it as the ``<base>_pipelined`` candidate.

    The payload is sliced into ``C`` chunks and chunk ``k``'s phase
    ``r`` runs while chunk ``k+1`` is still in phase ``r-1``, so phases
    on *disjoint* link classes overlap across chunks; phases sharing a
    link class (e.g. the hierarchical RS and AG, both on the inner
    axis) still serialize on those wires.  Steady state is therefore
    paced by the most-loaded link class, and the closed form is

        T_pipe(C) = sum_i t_i(B/C) + (C - 1) * max_class sum_cls t_i(B/C)

    (ramp: every phase once at chunk size, then C-1 more chunks behind
    the bottleneck class).  Per-phase launch/depth overhead is inside
    every ``t_i(B/C)`` -- charged per chunk -- so small payloads price
    pipelining out on their own.  The model keeps the argmin C over
    :data:`PIPELINE_CHUNK_CANDIDATES`; chunk bytes round up to whole
    elements so the C chunks never total less than the real payload."""
    base_t = shapes[base][0]
    best: Optional[Tuple[float, int, List[PlanStep],
                         Dict[int, float]]] = None
    for c in PIPELINE_CHUNK_CANDIDATES:
        cb = ceil_div(ceil_div(nbytes, c), element_bytes) * element_bytes
        t_sum, steps, ab, phases = score_chunk(cb)
        classes: Dict[Tuple[int, ...], float] = {}
        for t_i, cls_axes in phases:
            key = tuple(sorted(cls_axes))
            classes[key] = classes.get(key, 0.0) + t_i
        if len(classes) < 2:
            return      # everything rides one link class: no overlap
        t_pipe = t_sum + (c - 1) * max(classes.values())
        if best is None or t_pipe < best[0]:
            best = (t_pipe, c, steps, ab)
    if best is None:
        return
    t_pipe, c, steps, ab = best
    name = f"{base}_pipelined"
    # total wire bytes = per-chunk bytes x chunk count (slightly above
    # the serialized shape's when chunking pads the last chunk)
    shapes[name] = (t_pipe, steps, {i: v * c for i, v in ab.items()})
    extras[name] = {"n_chunks": c, "overlap_saved": base_t - t_pipe}


def _plan_allreduce(sizes: Tuple[int, ...], nbytes: int, fabric: Fabric,
                    element_bytes: int, select: SelectFn,
                    force_shape: Optional[str] = None,
                    axis_fabrics: Optional[Sequence[Fabric]] = None
                    ) -> Dict[str, Any]:
    b = _elements(nbytes, element_bytes)
    eff = _effective(sizes)
    fabs = _axis_fabrics(sizes, fabric, axis_fabrics)
    shapes: Dict[str, Tuple[float, List[PlanStep], Dict[int, float]]] = {}
    extras: Dict[str, Dict[str, Any]] = {}

    t, steps, ab, _ = _score_sequential("allreduce", sizes, nbytes,
                                        select, fabs)
    shapes["sequential"] = (t, steps, ab)

    if len(eff) >= 2:
        shapes["latency"] = _score_latency("allreduce", sizes, nbytes,
                                           element_bytes, fabs)[:3]
        f_t, f_steps, f_ab, _ = _score_flat("allreduce", sizes, nbytes,
                                            select, fabs)
        shapes["flat"] = (f_t, f_steps, f_ab)
        h_t, h_steps, h_ab, _ = _score_hierarchical(
            sizes, nbytes, fabric, element_bytes, select, fabs)
        shapes["hierarchical"] = (h_t, h_steps, h_ab)
        _add_pipelined(shapes, extras, "sequential", nbytes,
                       element_bytes,
                       lambda cb: _score_sequential("allreduce", sizes,
                                                    cb, select, fabs))
        _add_pipelined(shapes, extras, "hierarchical", nbytes,
                       element_bytes,
                       lambda cb: _score_hierarchical(sizes, cb, fabric,
                                                      element_bytes,
                                                      select, fabs))

    if len(eff) == 2:
        (mi, m), (ni, n) = eff
        fm, fn_ = fabs[mi], fabs[ni]
        bc = t_broadcast_2d_fabric(m, n, b, fabric, fabric_m=fm,
                                   fabric_n=fn_)
        pm, tm = _best_reduce_pattern(m, b, fm)
        pn, tn = _best_reduce_pattern(n, b, fn_)
        xy_bytes = {mi: _wire_bytes(nbytes, m) * 2.0,
                    ni: _wire_bytes(nbytes, n) * 2.0}
        shapes["2d_xy"] = (
            tm + tn + bc,
            [PlanStep("xy_allreduce", (mi, ni), f"{pm}x{pn}", nbytes)],
            xy_bytes)
        snake_bytes = {mi: _wire_bytes(nbytes, m) * 2.0,
                       ni: _wire_bytes(nbytes, n) * 2.0}
        # one boustrophedon chain crosses both link classes
        snake_fab = slowest_fabric(fm, fn_)
        shapes["2d_snake"] = (
            pat.t_snake_reduce(m, n, b, snake_fab) + bc,
            [PlanStep("snake_allreduce", (mi, ni), "snake", nbytes)],
            snake_bytes)

    return _finish("allreduce", sizes, nbytes, fabric, element_bytes,
                   shapes, force_shape, fabs, extras)


def _score_a2a_phases(nbytes: int, select: SelectFn, fabs: AxisFabrics,
                      order: Sequence[Tuple[int, int]]
                      ) -> ScoredShape:
    """One full-B all-to-all per axis, in ``order``: each phase settles
    that axis's destination sub-index (the data stays B bytes per device
    throughout -- AllToAll conserves volume)."""
    t = 0.0
    steps: List[PlanStep] = []
    axis_bytes: Dict[int, float] = {}
    phases: PhaseList = []
    for i, p in order:
        d = select("all_to_all", nbytes, p, fabric=fabs[i])
        t += d.predicted
        steps.append(PlanStep("all_to_all", (i,), d.algorithm, nbytes))
        axis_bytes[i] = _wire_bytes(nbytes, p)
        phases.append((d.predicted, (i,)))
    return t, steps, axis_bytes, phases


def _plan_all_to_all(sizes: Tuple[int, ...], nbytes: int, fabric: Fabric,
                     element_bytes: int, select: SelectFn,
                     force_shape: Optional[str] = None,
                     axis_fabrics: Optional[Sequence[Fabric]] = None
                     ) -> Dict[str, Any]:
    """AllToAll joint plans.

    * ``hierarchical`` -- the 2-phase intra-pod/inter-pod decomposition
      (generalized to k phases): exchange along the innermost axis
      first, aggregating each pod's cross-pod traffic into contiguous
      per-pod stripes, then along the outer axes.  Cross-pod wire bytes
      drop to B*(M-1)/M per device -- the quantity the flat single-shot
      is (conservatively) charged on every link class it folds.
    * ``sequential`` -- the same per-axis factorization in the naive
      outermost-first order.  AllToAll conserves bytes, so its model
      price equals hierarchical's; ties resolve to ``hierarchical``
      (inserted first), which is also the order that aggregates
      cross-pod messages before they hit the slow links.
    * ``flat``       -- one single-shot exchange over the row-major
      folded axis (depth P-1), priced at the slowest member fabric with
      every axis charged the full folded traffic.
    """
    eff = _effective(sizes)
    fabs = _axis_fabrics(sizes, fabric, axis_fabrics)
    shapes: Dict[str, Tuple[float, List[PlanStep], Dict[int, float]]] = {}
    extras: Dict[str, Dict[str, Any]] = {}
    if len(eff) < 2:
        shapes["sequential"] = _score_a2a_phases(nbytes, select, fabs,
                                                 list(eff))[:3]
    else:
        shapes["hierarchical"] = _score_a2a_phases(
            nbytes, select, fabs, list(reversed(eff)))[:3]
        shapes["sequential"] = _score_a2a_phases(nbytes, select, fabs,
                                                 list(eff))[:3]
        shapes["latency"] = _score_latency("all_to_all", sizes, nbytes,
                                           element_bytes, fabs)[:3]
        shapes["flat"] = _score_flat("all_to_all", sizes, nbytes, select,
                                     fabs)[:3]
        _add_pipelined(shapes, extras, "hierarchical", nbytes,
                       element_bytes,
                       lambda cb: _score_a2a_phases(cb, select, fabs,
                                                    list(reversed(eff))))
        _add_pipelined(shapes, extras, "sequential", nbytes,
                       element_bytes,
                       lambda cb: _score_a2a_phases(cb, select, fabs,
                                                    list(eff)))
    return _finish("all_to_all", sizes, nbytes, fabric, element_bytes,
                   shapes, force_shape, fabs, extras)


def _plan_sharded(op: str, sizes: Tuple[int, ...], nbytes: int,
                  fabric: Fabric, element_bytes: int, select: SelectFn,
                  force_shape: Optional[str] = None,
                  axis_fabrics: Optional[Sequence[Fabric]] = None
                  ) -> Dict[str, Any]:
    eff = _effective(sizes)
    fabs = _axis_fabrics(sizes, fabric, axis_fabrics)
    shapes: Dict[str, Tuple[float, List[PlanStep], Dict[int, float]]] = {}
    extras: Dict[str, Dict[str, Any]] = {}
    shapes["cascade"] = _score_cascade(op, sizes, nbytes, select,
                                       fabs)[:3]
    if len(eff) >= 2:
        if op == "allgather":
            shapes["latency"] = _score_latency(op, sizes, nbytes,
                                               element_bytes, fabs)[:3]
        shapes["flat"] = _score_flat(op, sizes, nbytes, select, fabs)[:3]
        _add_pipelined(shapes, extras, "cascade", nbytes, element_bytes,
                       lambda cb: _score_cascade(op, sizes, cb, select,
                                                 fabs))
    return _finish(op, sizes, nbytes, fabric, element_bytes, shapes,
                   force_shape, fabs, extras)


def _finish(op: str, sizes: Tuple[int, ...], nbytes: int, fabric: Fabric,
            element_bytes: int,
            shapes: Dict[str, Tuple[float, List[PlanStep],
                                    Dict[int, float]]],
            force_shape: Optional[str] = None,
            axis_fabrics: Optional[Sequence[Fabric]] = None,
            extras: Optional[Dict[str, Dict[str, Any]]] = None
            ) -> Dict[str, Any]:
    extras = extras or {}
    if not any(p > 1 for p in sizes):
        return {"op": op, "sizes": list(sizes), "nbytes": nbytes,
                "shape": "identity", "steps": [], "predicted": 0.0,
                "predictions": {}, "cost_terms": {}, "lower_bound": 0.0,
                "n_chunks": 1}
    lb = lower_bound_multi(op, sizes, nbytes, fabric, element_bytes,
                           axis_fabrics)
    predictions = {name: t for name, (t, _, _) in shapes.items()}
    for name, t in predictions.items():
        if t < lb - 1e-6:
            raise RuntimeError(
                f"model inconsistency: {op} shape {name!r} predicts "
                f"{t:.3f} cycles, below the lower bound {lb:.3f} "
                f"for topology {tuple(sizes)} at {nbytes} bytes")
    if force_shape is not None:
        if force_shape not in shapes:
            raise ValueError(
                f"shape {force_shape!r} is not a candidate for {op} "
                f"over {tuple(sizes)}; have {sorted(shapes)}")
        best = force_shape
    else:
        best = min(predictions, key=predictions.get)
    t_best, steps, _ = shapes[best]
    cost_terms = {
        name: dict({"predicted": t,
                    "axis_bytes": {str(i): v for i, v in ab.items()}},
                   **extras.get(name, {}))
        for name, (t, _, ab) in shapes.items()}
    return {"op": op, "sizes": list(sizes), "nbytes": nbytes,
            "shape": best,
            "steps": [{"kind": s.kind, "axes": list(s.axes),
                       "algorithm": s.algorithm, "nbytes": s.nbytes}
                      for s in steps],
            "predicted": t_best, "predictions": predictions,
            "cost_terms": cost_terms, "lower_bound": lb,
            "n_chunks": int(extras.get(best, {}).get("n_chunks", 1))}


# ---------------------------------------------------------------------- #
# public entry points
# ---------------------------------------------------------------------- #
def plan_collective(op: str, sizes: Sequence[int], nbytes: int,
                    fabric: Fabric, element_bytes: int,
                    select: SelectFn,
                    force_shape: Optional[str] = None,
                    axis_fabrics: Optional[Sequence[Fabric]] = None
                    ) -> Dict[str, Any]:
    """Produce the positional (unbound) plan record for a topology.

    ``select(op, nbytes, p, topo=None, fabric=None)`` prices one
    per-axis candidate with that axis's constants; the engine passes its
    cached ``Decision``-returning ``select`` so every per-axis
    sub-decision lands in the persistent cache.  ``axis_fabrics`` gives
    each positional axis its own :class:`Fabric` (heterogeneous
    topology); ``None`` prices every axis with ``fabric`` -- the
    uniform fast path, bit-for-bit the single-fabric planner.
    ``force_shape`` overrides the argmin with a named candidate (still
    scored and lower-bound-validated alongside the others).
    """
    sizes = tuple(int(s) for s in sizes)
    if op == "allreduce":
        return _plan_allreduce(sizes, nbytes, fabric, element_bytes,
                               select, force_shape, axis_fabrics)
    if op in ("reduce_scatter", "allgather"):
        return _plan_sharded(op, sizes, nbytes, fabric, element_bytes,
                             select, force_shape, axis_fabrics)
    if op == "all_to_all":
        return _plan_all_to_all(sizes, nbytes, fabric, element_bytes,
                                select, force_shape, axis_fabrics)
    raise ValueError(f"no multi-axis planner for op {op!r}")


def bind_plan(record: Dict[str, Any], op: str,
              axes: Sequence[str]) -> CollectivePlan:
    """Rebind a positional plan record to concrete grid axis names."""
    axes = tuple(axes)
    sizes = tuple(int(s) for s in record["sizes"])
    steps = tuple(
        PlanStep(kind=s["kind"],
                 axes=tuple(axes[int(i)] for i in s["axes"]),
                 algorithm=s["algorithm"], nbytes=int(s["nbytes"]))
        for s in record["steps"])
    cost_terms = {}
    for shape, entry in record["cost_terms"].items():
        bound = {"predicted": float(entry["predicted"]),
                 "axis_bytes": {axes[int(i)]: float(v)
                                for i, v in entry["axis_bytes"].items()}}
        for k, v in entry.items():
            if k not in bound:
                bound[k] = v       # pipelined extras: n_chunks, ...
        cost_terms[shape] = bound
    return CollectivePlan(
        op=op, axes=axes, axis_sizes=sizes, nbytes=int(record["nbytes"]),
        shape=record["shape"], steps=steps,
        predicted=float(record["predicted"]),
        predictions={k: float(v)
                     for k, v in record["predictions"].items()},
        cost_terms=cost_terms, lower_bound=float(record["lower_bound"]),
        n_chunks=int(record.get("n_chunks", 1)))


__all__ = ["CollectivePlan", "PlanStep", "plan_collective", "bind_plan",
           "lower_bound_multi", "base_shape", "ALLREDUCE_SHAPES",
           "SHARDED_SHAPES", "ALL_TO_ALL_SHAPES",
           "PIPELINE_CHUNK_CANDIDATES"]
