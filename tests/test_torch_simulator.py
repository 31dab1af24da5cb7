"""The port's flow and fabric simulators (``repro_torch.simulator``)
against the reference's, on the cases of tests/test_simulator.py: both
are the same numpy over bit-identical trees and fabrics, so every cycle
count, sum and comparison is ``==``.  Then the port's planner against
the port's simulator, as tests/test_planner.py holds the reference's:
its 2D prices are the closed forms ``runner.compare_allreduce_2d``
checks."""

import dataclasses
import random

import numpy as np
import pytest

import repro.core.autogen as j_autogen
import repro.core.model as j_model
import repro.core.schedule as j_sched
import repro.simulator.fabric as j_fabric
import repro.simulator.flow as j_flow
import repro.simulator.runner as j_runner
import repro_torch.core.autogen as t_autogen
import repro_torch.core.model as t_model
import repro_torch.core.schedule as t_sched
import repro_torch.simulator.fabric as t_fabric
import repro_torch.simulator.flow as t_flow
import repro_torch.simulator.runner as t_runner
from repro_torch.collectives.engine import (CollectiveEngine,
                                            ICI_ELEMENT_BYTES)
from tests.util_trees import random_pre_order_tree

TREES = ("chain_tree", "star_tree", "binary_tree", "two_phase_tree")


@pytest.fixture(autouse=True)
def _private_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "torch"))


def _fab(t_r=None):
    j = j_model.WSE2 if t_r is None else dataclasses.replace(
        j_model.WSE2, name=f"tr{t_r}", t_r=t_r)
    return j, t_model.Fabric(**dataclasses.asdict(j))


def _same_result(t, j):
    assert type(t).__name__ == type(j).__name__
    assert t.cycles == j.cycles
    if hasattr(j, "root_sum"):
        assert np.array_equal(t.root_sum, j.root_sum)
    if hasattr(j, "label"):
        assert t.label == j.label


@pytest.mark.parametrize("tree", TREES)
def test_flow_reduce_equals_the_reference(tree):
    for p in (2, 4, 8, 16, 32, 64, 512):
        for b in (1, 64, 1024, 4096):
            if tree == "binary_tree" and p & (p - 1):
                continue
            _same_result(
                t_flow.simulate_reduce_tree(getattr(t_sched, tree)(p), b),
                j_flow.simulate_reduce_tree(getattr(j_sched, tree)(p), b))


def test_flow_broadcast_ring_and_allreduce_equal_the_reference():
    jf, tf = _fab()
    for p in (2, 4, 16, 32, 512):
        for b in (1, 256, 4096, 65536):
            _same_result(t_flow.simulate_broadcast(p, b, tf),
                         j_flow.simulate_broadcast(p, b, jf))
            _same_result(t_flow.simulate_ring_allreduce(p, b, tf),
                         j_flow.simulate_ring_allreduce(p, b, jf))
            _same_result(
                t_flow.simulate_allreduce(t_sched.chain_tree(p), b, tf),
                j_flow.simulate_allreduce(j_sched.chain_tree(p), b, jf))
    for m, n in ((2, 4), (4, 4), (8, 8)):
        _same_result(t_flow.simulate_broadcast_2d(m, n, 256, tf),
                     j_flow.simulate_broadcast_2d(m, n, 256, jf))
        _same_result(
            t_flow.simulate_xy_allreduce(t_sched.chain_tree(n),
                                         t_sched.chain_tree(m), 256, m, n,
                                         tf),
            j_flow.simulate_xy_allreduce(j_sched.chain_tree(n),
                                         j_sched.chain_tree(m), 256, m, n,
                                         jf))


@pytest.mark.parametrize("tree", ("chain_tree", "binary_tree",
                                  "two_phase_tree", "star_tree"))
def test_fabric_reduce_equals_the_reference(tree):
    """Cycle counts and exact root sums of the wavelet-level simulator
    (the fabric-vs-flow and star-overhead cases)."""
    for p in (2, 4, 8, 16, 32):
        if tree == "star_tree" and p < 8 or tree != "star_tree" and p > 16:
            continue
        for b in (8, 64, 256):
            data = np.random.default_rng(p * b).standard_normal((p, b))
            _same_result(
                t_fabric.simulate_reduce_fabric(getattr(t_sched, tree)(p),
                                                b, data=data),
                j_fabric.simulate_reduce_fabric(getattr(j_sched, tree)(p),
                                                b, data=data))


def test_fabric_fractional_t_r_and_broadcast_equal_the_reference():
    for t_r in (2.0, 2.25, 2.5, 3.0):
        jf, tf = _fab(t_r)
        for p, b in ((4, 16), (8, 32)):
            data = np.random.default_rng(1).standard_normal((p, b))
            _same_result(
                t_fabric.simulate_reduce_fabric(t_sched.chain_tree(p), b,
                                                data=data, fabric=tf),
                j_fabric.simulate_reduce_fabric(j_sched.chain_tree(p), b,
                                                data=data, fabric=jf))
        _same_result(t_fabric.simulate_broadcast_fabric(4, 8, fabric=tf),
                     j_fabric.simulate_broadcast_fabric(4, 8, fabric=jf))


def test_fabric_autogen_and_random_trees_equal_the_reference():
    jt = j_autogen.compute_tables(16, use_cache=False)
    tt = t_autogen.compute_tables(16, use_cache=False)
    for b in (1, 16, 128):
        _same_result(
            t_fabric.simulate_reduce_fabric(
                t_autogen.autogen_tree(16, b, tables=tt), b),
            j_fabric.simulate_reduce_fabric(
                j_autogen.autogen_tree(16, b, tables=jt), b))
    rng = random.Random(0)
    for _ in range(6):
        p = rng.randint(3, 14)
        b = rng.choice([4, 16, 64])
        jtree = random_pre_order_tree(p, rng)
        ttree = t_sched.ReduceTree(list(jtree.parent),
                                   [list(c) for c in jtree.children],
                                   root=jtree.root, label=jtree.label)
        _same_result(t_fabric.simulate_reduce_fabric(ttree, b),
                     j_fabric.simulate_reduce_fabric(jtree, b))
        _same_result(t_flow.simulate_reduce_tree(ttree, b),
                     j_flow.simulate_reduce_tree(jtree, b))


def _same_comparison(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.rel_error == j.rel_error


@pytest.mark.parametrize("pattern", ("chain", "tree", "two_phase",
                                     "autogen", "star"))
def test_runner_comparisons_equal_the_reference(pattern):
    jt = j_autogen.compute_tables(64, use_cache=False)
    tt = t_autogen.compute_tables(64, use_cache=False)
    for b in (1, 16, 256, 4096):
        _same_comparison(t_runner.compare_reduce(pattern, 64, b, tables=tt),
                         j_runner.compare_reduce(pattern, 64, b, tables=jt))
        _same_comparison(
            t_runner.compare_allreduce(pattern, 64, b, tables=tt),
            j_runner.compare_allreduce(pattern, 64, b, tables=jt))
    for m, n in ((4, 4), (8, 8)):
        for b in (64, 256, 4096):
            _same_comparison(
                t_runner.compare_allreduce_2d(pattern, m, n, b, tables=tt),
                j_runner.compare_allreduce_2d(pattern, m, n, b, tables=jt))


def test_runner_snake_ring_and_broadcast_equal_the_reference():
    for m, n in ((4, 4), (8, 8), (2, 16)):
        for b in (64, 256, 4096):
            _same_comparison(t_runner.compare_reduce_2d("snake", m, n, b),
                             j_runner.compare_reduce_2d("snake", m, n, b))
            _same_comparison(
                t_runner.compare_allreduce_2d("snake", m, n, b),
                j_runner.compare_allreduce_2d("snake", m, n, b))
    for p in (4, 8, 16, 32):
        _same_comparison(t_runner.compare_allreduce("ring", p, 4096),
                         j_runner.compare_allreduce("ring", p, 4096))
        _same_comparison(t_runner.compare_broadcast(p, 4096),
                         j_runner.compare_broadcast(p, 4096))


def test_planner_2d_pricing_matches_the_ports_flow_simulator():
    """tests/test_planner.py's cross-check on the port: on WSE2 the
    planner's snake candidate is the closed form the flow simulator
    checks, within the paper's error envelope, and its X-Y candidate
    (best pattern per dimension) lower-bounds each uniform-pattern X-Y."""
    wse2 = t_model.WSE2
    eng = CollectiveEngine(fabric=wse2, persist=False, device="cpu")
    for m, n in ((4, 4), (8, 8)):
        for b in (64, 4096):
            plan = eng.plan_multi("allreduce", ("y", "x"), (m, n),
                                  b * ICI_ELEMENT_BYTES)
            cmp = t_runner.compare_allreduce_2d("snake", m, n, b, wse2)
            assert plan.predictions["2d_snake"] == cmp.model_cycles
            assert cmp.rel_error < 0.35, (m, n, b, cmp)
            for pattern in ("chain", "two_phase"):
                uni = t_runner.compare_allreduce_2d(pattern, m, n, b, wse2)
                assert plan.predictions["2d_xy"] <= uni.model_cycles + 1e-6
