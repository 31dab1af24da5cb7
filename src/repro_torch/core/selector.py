"""Model-driven algorithm selection (the paper's Figs. 1, 8, 10).

Given (B, P) -- and a fabric parameterization -- evaluate every pattern
under the performance model and pick the winner.  This is the mechanism the
paper uses both to choose collectives and to generate Fig. 8/10 heatmaps,
and the mechanism our TPU collective layer reuses with ICI constants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence


from repro_torch.core import patterns as pat
from repro_torch.core.autogen import AutoGenTables, compute_tables, t_autogen
from repro_torch.core.lowerbound import compute_lb_energy, t_lower_bound
from repro_torch.core.model import Fabric, WSE2, slowest_fabric


@dataclasses.dataclass
class Selection:
    name: str
    predicted_cycles: float
    all_predictions: Dict[str, float]


def predict_reduce(p: int, b: int, fabric: Fabric = WSE2,
                   include_autogen: bool = True,
                   tables: Optional[AutoGenTables] = None) -> Dict[str, float]:
    preds = {name: fn(p, b, fabric) for name, fn in pat.REDUCE_PATTERNS.items()
             if name != "tree" or (p & (p - 1)) == 0}
    if include_autogen:
        preds["autogen"], _ = t_autogen(p, b, fabric, tables)
    return preds


def best_reduce(p: int, b: int, fabric: Fabric = WSE2,
                include_autogen: bool = True,
                tables: Optional[AutoGenTables] = None) -> Selection:
    preds = predict_reduce(p, b, fabric, include_autogen, tables)
    name = min(preds, key=preds.get)
    return Selection(name, preds[name], preds)


def predict_allreduce(p: int, b: int, fabric: Fabric = WSE2,
                      include_autogen: bool = True,
                      tables: Optional[AutoGenTables] = None
                      ) -> Dict[str, float]:
    preds: Dict[str, float] = {}
    for name in pat.ALLREDUCE_PATTERNS:
        if name == "tree" and (p & (p - 1)) != 0:
            continue
        preds[name] = pat.t_allreduce(name, p, b, fabric)
    if include_autogen:
        t_red, _ = t_autogen(p, b, fabric, tables)
        preds["autogen"] = pat.t_reduce_then_broadcast(t_red, p, b, fabric)
    return preds


def best_allreduce(p: int, b: int, fabric: Fabric = WSE2,
                   include_autogen: bool = True,
                   tables: Optional[AutoGenTables] = None) -> Selection:
    preds = predict_allreduce(p, b, fabric, include_autogen, tables)
    name = min(preds, key=preds.get)
    return Selection(name, preds[name], preds)


# ---------------------------------------------------------------------- #
# op-generic prediction: one entry point per collective kind.  This is
# the seam the CollectiveEngine dispatches through; each op returns the
# model estimate for every implemented backend.
# ---------------------------------------------------------------------- #
def predict_reduce_scatter(p: int, b: int, fabric: Fabric = WSE2,
                           include_autogen: bool = True,
                           tables: Optional[AutoGenTables] = None
                           ) -> Dict[str, float]:
    preds = {name: fn(p, b, fabric)
             for name, fn in pat.REDUCE_SCATTER_PATTERNS.items()}
    if include_autogen and p > 1:
        # implemented as P rotated per-chunk tree reduces over B/P
        # elements, serialized in the trace -- model the serialization.
        t_chunk, _ = t_autogen(p, max(1, -(-b // p)), fabric, tables)
        preds["autogen"] = p * t_chunk
    return preds


def predict_allgather(p: int, b: int, fabric: Fabric = WSE2,
                      include_autogen: bool = True,
                      tables: Optional[AutoGenTables] = None
                      ) -> Dict[str, float]:
    preds = {name: fn(p, b, fabric)
             for name, fn in pat.ALLGATHER_PATTERNS.items()
             if name != "doubling" or (p & (p - 1)) == 0}
    if include_autogen and p > 1:
        # reversed reduce schedule per rotated chunk (see shardmap_impl)
        t_chunk, _ = t_autogen(p, max(1, -(-b // p)), fabric, tables)
        preds["autogen"] = p * t_chunk
    return preds


def predict_broadcast(p: int, b: int, fabric: Fabric = WSE2,
                      include_autogen: bool = True,
                      tables: Optional[AutoGenTables] = None
                      ) -> Dict[str, float]:
    preds = {name: fn(p, b, fabric)
             for name, fn in pat.BROADCAST_PATTERNS.items()}
    if include_autogen and p > 1:
        # broadcast down the reversed Auto-Gen tree costs what the
        # reduce up it does (same edges, store replaced by copy)
        preds["autogen"], _ = t_autogen(p, b, fabric, tables)
    return preds


def predict_all_to_all(p: int, b: int, fabric: Fabric = WSE2,
                       include_autogen: bool = True,
                       tables: Optional[AutoGenTables] = None
                       ) -> Dict[str, float]:
    """AllToAll has no reduction tree, so there is no Auto-Gen backend:
    the candidate set is the closed-form patterns (injection-optimal
    pairwise ring vs log-launch Bruck halving).  ``include_autogen`` /
    ``tables`` are accepted for signature uniformity and ignored."""
    del include_autogen, tables
    preds = {name: fn(p, b, fabric)
             for name, fn in pat.ALL_TO_ALL_PATTERNS.items()}
    return preds


def best_all_to_all(p: int, b: int, fabric: Fabric = WSE2) -> Selection:
    preds = predict_all_to_all(p, b, fabric)
    name = min(preds, key=preds.get)
    return Selection(name, preds[name], preds)


_OP_PREDICTORS = {
    "reduce": predict_reduce,
    "allreduce": predict_allreduce,
    "reduce_scatter": predict_reduce_scatter,
    "allgather": predict_allgather,
    "broadcast": predict_broadcast,
    "all_to_all": predict_all_to_all,
}

COLLECTIVE_OPS = tuple(_OP_PREDICTORS)


def predict_collective(op: str, p: int, b: int, fabric: Fabric = WSE2,
                       include_autogen: bool = True,
                       tables: Optional[AutoGenTables] = None
                       ) -> Dict[str, float]:
    try:
        fn = _OP_PREDICTORS[op]
    except KeyError:
        raise ValueError(f"unknown collective op {op!r}; "
                         f"expected one of {COLLECTIVE_OPS}") from None
    return fn(p, b, fabric, include_autogen, tables)


def best_collective(op: str, p: int, b: int, fabric: Fabric = WSE2,
                    include_autogen: bool = True,
                    tables: Optional[AutoGenTables] = None) -> Selection:
    preds = predict_collective(op, p, b, fabric, include_autogen, tables)
    name = min(preds, key=preds.get)
    return Selection(name, preds[name], preds)


# ---------------------------------------------------------------------- #
# heatmaps (Figs. 8 and 10): best fixed algorithm per (B, P) cell
# ---------------------------------------------------------------------- #
def heatmap_1d_allreduce(b_values: Sequence[int], p_values: Sequence[int],
                         fabric: Fabric = WSE2) -> List[List[str]]:
    grid = []
    for b in b_values:
        row = []
        for p in p_values:
            row.append(best_allreduce(p, b, fabric,
                                      include_autogen=False).name)
        grid.append(row)
    return grid


def t_broadcast_2d_fabric(m: int, n: int, b: int,
                          fabric: Fabric = WSE2,
                          fabric_m: Optional[Fabric] = None,
                          fabric_n: Optional[Fabric] = None) -> float:
    """2D broadcast honoring the fabric: flooding multicast on the WSE
    (Lemma 7.1), per-axis log-depth doubling where multicast is missing
    (ICI) -- what the 2D shard_map implementation actually executes.

    ``fabric_m`` / ``fabric_n`` price each grid dimension with its own
    axis-local constants; the flooding form (one stream crossing both
    dimensions) conservatively takes the slower of the two."""
    fm = fabric_m or fabric
    fn_ = fabric_n or fabric
    if fm == fn_:
        if fm.multicast:
            return pat.t_broadcast_2d(m, n, b, fm)
        return (pat.t_doubling_broadcast(m, b, fm)
                + pat.t_doubling_broadcast(n, b, fm))
    if fm.multicast and fn_.multicast:
        return pat.t_broadcast_2d(m, n, b, slowest_fabric(fm, fn_))
    return (pat.t_doubling_broadcast(m, b, fm)
            + pat.t_doubling_broadcast(n, b, fn_))


def predict_allreduce_2d(m: int, n: int, b: int, fabric: Fabric = WSE2,
                         fabric_m: Optional[Fabric] = None,
                         fabric_n: Optional[Fabric] = None
                         ) -> Dict[str, float]:
    """2D AllReduce candidates over an M x N grid (Sec. 7.4): every X-Y
    pattern plus the snake, each composed with the fabric-appropriate
    2D broadcast.  The seam the topology planner and the Fig. 10
    heatmap share.  Per-axis constants (``fabric_m``/``fabric_n``)
    price each grid dimension with its own fabric; the snake chain --
    which crosses both link classes -- takes the slower of the two."""
    fm = fabric_m or fabric
    fn_ = fabric_n or fabric
    bc = t_broadcast_2d_fabric(m, n, b, fabric, fabric_m=fm, fabric_n=fn_)
    preds: Dict[str, float] = {}
    for name in ("star", "chain", "tree", "two_phase"):
        if name == "tree" and ((m & (m - 1)) != 0 or (n & (n - 1)) != 0):
            continue
        preds[f"xy_{name}"] = pat.t_xy_reduce(name, m, n, b, fabric,
                                              fabric_m=fm,
                                              fabric_n=fn_) + bc
    preds["snake"] = pat.t_snake_reduce(m, n, b,
                                        slowest_fabric(fm, fn_)) + bc
    return preds


def heatmap_2d_allreduce(b_values: Sequence[int], side_values: Sequence[int],
                         fabric: Fabric = WSE2) -> List[List[str]]:
    """Best fixed 2D AllReduce (X-Y pattern + bcast, or snake + bcast)."""
    grid = []
    for b in b_values:
        row = []
        for side in side_values:
            preds = predict_allreduce_2d(side, side, b, fabric)
            row.append(min(preds, key=preds.get))
        grid.append(row)
    return grid


def optimality_ratios(p: int, b_values: Sequence[int], fabric: Fabric = WSE2,
                      tables: Optional[AutoGenTables] = None,
                      lb_table=None) -> Dict[str, List[float]]:
    """Fig. 1: pattern cost / lower bound, per vector length."""
    if tables is None:
        tables = compute_tables(p)
    if lb_table is None:
        lb_table = compute_lb_energy(p)
    out: Dict[str, List[float]] = {}
    for b in b_values:
        lb = max(t_lower_bound(p, b, fabric, lb_table), 1e-9)
        preds = predict_reduce(p, b, fabric, include_autogen=True,
                               tables=tables)
        for name, t in preds.items():
            out.setdefault(name, []).append(t / lb)
    return out


__all__ = [
    "Selection", "predict_reduce", "best_reduce", "predict_allreduce",
    "best_allreduce", "predict_reduce_scatter", "predict_allgather",
    "predict_broadcast", "predict_all_to_all", "best_all_to_all",
    "predict_collective", "best_collective",
    "predict_allreduce_2d", "t_broadcast_2d_fabric",
    "COLLECTIVE_OPS", "heatmap_1d_allreduce", "heatmap_2d_allreduce",
    "optimality_ratios",
]
