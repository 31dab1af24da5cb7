"""The comparison that decides ``correct``: the numbers a run compares,
each held against its limit from ``perfbench/workloads/<cell>.json``.

Training compares three numbers with the plain reference over the
first steps (``train_numbers``):

* ``loss_gap``: the widest relative gap between a step's loss and the
  reference's;
* ``grad_gap``: the first step's gradient as the optimizer gets it (the
  norm of each leaf, worked out from its first moment), by the worst
  leaf: the gap between the two norms over the reference's norm of that
  leaf or of the median leaf, whichever is larger;
* ``change_gap``: the same measure of each leaf's change after the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import json
import statistics
from typing import Dict, List, Optional, Tuple

from perfbench.lib.manifest import PERFBENCH

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of ``change_gap``
STILL_LEAF = 1e-3


def limits(cell: str) -> dict:
    """The cell's limits: ``{number: {"limit": x, ...}}``; a number
    whose limit is null is read and printed but not compared."""
    with open(PERFBENCH / "workloads" / f"{cell}.json") as f:
        return json.load(f)["checks"]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap (see the module docstring) and its name."""
    med = statistics.median(ref[n] for n in names)
    worst, which = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap >= worst:
            worst, which = gap, n
    return worst, which


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``loss`` (each step's), ``grad`` (leaf ->
    norm of the first gradient), ``change`` (leaf -> norm of the change
    after the steps)."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["loss"], ref["loss"]))
    names = sorted(ref["grad"])
    grad_gap, grad_leaf = leaf_gap(prog["grad"], ref["grad"], names)
    med = statistics.median(ref["grad"][n] for n in names)
    moving = [n for n in names if ref["grad"][n] >= STILL_LEAF * med]
    change_gap, change_leaf = leaf_gap(prog["change"], ref["change"],
                                       moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "detail": {"grad_leaf": grad_leaf, "change_leaf": change_leaf,
                       "still_leaves": len(names) - len(moving)}}


def judge(numbers: dict, cell_limits: dict
          ) -> Tuple[bool, List[Tuple[str, float, Optional[float]]]]:
    """(correct, [(name, value, limit)]): correct when every number with
    a limit lies at or under it (and is a number at all)."""
    rows, ok = [], True
    for name, spec in cell_limits.items():
        value = numbers.get(name)
        limit = spec.get("limit")
        if value is None or value != value:        # missing or NaN
            ok = False
            rows.append((name, float("nan"), limit))
            continue
        if limit is not None and not value <= limit:
            ok = False
        rows.append((name, float(value), limit))
    return ok, rows
