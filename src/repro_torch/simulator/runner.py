"""Run model predictions against the simulators and report errors.

This is the reproduction analogue of the paper's CS-2 measurements: the
flow simulator plays the role of the machine (deterministic, Sec. 8.1),
and we report ``|model - sim| / sim`` relative errors per pattern, as the
paper does per figure.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import patterns as pat
from repro_torch.core.autogen import AutoGenTables, autogen_tree, t_autogen
from repro_torch.core.model import Fabric, WSE2
from repro_torch.core.schedule import (ReduceTree, binary_tree,
                                       chain_tree, snake_tree, star_tree,
                                       two_phase_tree)
from repro_torch.simulator import flow


@dataclasses.dataclass
class Comparison:
    pattern: str
    p: int
    b: int
    model_cycles: float
    sim_cycles: float

    @property
    def rel_error(self) -> float:
        if self.sim_cycles == 0:
            return 0.0
        return abs(self.model_cycles - self.sim_cycles) / self.sim_cycles


def _tree_for(pattern: str, p: int, b: int,
              tables: Optional[AutoGenTables] = None) -> ReduceTree:
    if pattern == "star":
        return star_tree(p)
    if pattern == "chain":
        return chain_tree(p)
    if pattern == "tree":
        return binary_tree(p)
    if pattern == "two_phase":
        return two_phase_tree(p)
    if pattern == "autogen":
        return autogen_tree(p, b, tables=tables)
    raise KeyError(pattern)


def _model_reduce(pattern: str, p: int, b: int, fabric: Fabric,
                  tables: Optional[AutoGenTables]) -> float:
    if pattern == "autogen":
        t, _ = t_autogen(p, b, fabric, tables)
        return t
    return pat.REDUCE_PATTERNS[pattern](p, b, fabric)


def compare_reduce(pattern: str, p: int, b: int, fabric: Fabric = WSE2,
                   tables: Optional[AutoGenTables] = None) -> Comparison:
    tree = _tree_for(pattern, p, b, tables)
    sim = flow.simulate_reduce_tree(tree, b, fabric)
    model = _model_reduce(pattern, p, b, fabric, tables)
    return Comparison(pattern, p, b, model, sim.cycles)


def compare_allreduce(pattern: str, p: int, b: int, fabric: Fabric = WSE2,
                      tables: Optional[AutoGenTables] = None) -> Comparison:
    if pattern == "ring":
        sim = flow.simulate_ring_allreduce(p, b, fabric)
        model = pat.t_ring_allreduce(p, b, fabric)
    else:
        tree = _tree_for(pattern, p, b, tables)
        sim = flow.simulate_allreduce(tree, b, fabric)
        model = pat.t_reduce_then_broadcast(
            _model_reduce(pattern, p, b, fabric, tables), p, b, fabric)
    return Comparison(pattern, p, b, model, sim.cycles)


def compare_reduce_2d(pattern: str, m: int, n: int, b: int,
                      fabric: Fabric = WSE2,
                      tables: Optional[AutoGenTables] = None) -> Comparison:
    """X-Y patterns and the snake on an M x N grid."""
    if pattern == "snake":
        tree = snake_tree(m, n)
        sim = flow.simulate_reduce_tree(tree, b, fabric)
        model = pat.t_snake_reduce(m, n, b, fabric)
    else:
        row = _tree_for(pattern, n, b, tables)
        col = _tree_for(pattern, m, b, tables)
        sim = flow.simulate_xy_reduce(row, col, b, fabric)
        if pattern == "autogen":
            model = (_model_reduce(pattern, n, b, fabric, tables)
                     + _model_reduce(pattern, m, b, fabric, tables))
        else:
            model = pat.t_xy_reduce(pattern, m, n, b, fabric)
    return Comparison(f"xy_{pattern}" if pattern != "snake" else "snake",
                      m * n, b, model, sim.cycles)


def compare_allreduce_2d(pattern: str, m: int, n: int, b: int,
                         fabric: Fabric = WSE2,
                         tables: Optional[AutoGenTables] = None) -> Comparison:
    red = compare_reduce_2d(pattern, m, n, b, fabric, tables)
    bc_sim = flow.simulate_broadcast_2d(m, n, b, fabric)
    bc_model = pat.t_broadcast_2d(m, n, b, fabric)
    return Comparison(red.pattern + "+bcast2d", m * n, b,
                      red.model_cycles + bc_model,
                      red.sim_cycles + bc_sim.cycles)


def compare_broadcast(p: int, b: int, fabric: Fabric = WSE2) -> Comparison:
    sim = flow.simulate_broadcast(p, b, fabric)
    return Comparison("bcast", p, b, pat.t_broadcast(p, b, fabric),
                      sim.cycles)


__all__ = ["Comparison", "compare_reduce", "compare_allreduce",
           "compare_reduce_2d", "compare_allreduce_2d", "compare_broadcast"]
