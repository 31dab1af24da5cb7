"""The port's cost model (``repro_torch.core``) against the reference's
(``repro.core``): closed-form prices, Auto-Gen tables, trees and rounds,
lower bounds and selector argmins must be bit-identical, over the
sweeps of tests/test_model_costs.py, test_autogen.py, test_latency.py
and test_schedule.py.  Both packages run the same numpy arithmetic, so
every comparison is ``==`` (no tolerance)."""

import dataclasses
import math
import os
import random

import numpy as np
import pytest

import repro.core.autogen as j_autogen
import repro.core.lowerbound as j_lb
import repro.core.model as j_model
import repro.core.patterns as j_pat
import repro.core.schedule as j_sched
import repro.core.selector as j_sel
import repro_torch.core.autogen as t_autogen
import repro_torch.core.lowerbound as t_lb
import repro_torch.core.model as t_model
import repro_torch.core.patterns as t_pat
import repro_torch.core.schedule as t_sched
import repro_torch.core.selector as t_sel
from tests.util_trees import random_pre_order_tree

PS = (2, 3, 4, 5, 8, 12, 16, 64, 128)          # test_model_costs + odd P
BS = (1, 16, 256, 4096, 1 << 20)                # + test_latency's LARGE
FABRICS = {
    "wse2": j_model.WSE2,
    "tpu": j_model.TPU_V5E_AXIS,
    "slow_launch": dataclasses.replace(j_model.TPU_V5E_AXIS,
                                       name="tpu_slow", link_bw=0.25,
                                       t_r=352.0, t_launch=40.0),
}


@pytest.fixture(autouse=True)
def _private_caches(tmp_path, monkeypatch):
    """Both packages' table caches in a fresh directory each test."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "torch"))


def _port(fab):
    return t_model.Fabric(**dataclasses.asdict(fab))


def _same(a, b):
    """Bit-identical floats (inf == inf; nan never expected)."""
    if isinstance(a, dict):
        assert list(a) == list(b), (a, b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, float) and math.isnan(a):
        raise AssertionError("nan price")
    assert type(a) is type(b) or {type(a), type(b)} <= {int, float}, \
        (type(a), type(b))
    assert a == b, (a, b)


P_B_FUNCS = ("t_message", "t_broadcast", "t_star", "t_chain",
             "t_two_phase", "t_ring_allreduce", "t_ring_reduce_scatter",
             "t_ring_allgather", "t_chain_broadcast",
             "t_ring_all_to_all", "t_halving_all_to_all",
             "t_oneshot_allreduce", "t_oneshot_allgather",
             "t_oneshot_all_to_all", "t_all_to_all_lower_bound")
POW2_FUNCS = ("t_tree", "t_doubling_allgather", "t_doubling_broadcast")


def _fn(name, port):
    mods = (t_pat, t_lb) if port else (j_pat, j_lb)
    for m in mods:
        if hasattr(m, name):
            return getattr(m, name)
    raise AttributeError(name)


# ------------------------------ patterns -------------------------------- #
@pytest.mark.parametrize("fab", sorted(FABRICS))
@pytest.mark.parametrize("name", P_B_FUNCS + POW2_FUNCS)
def test_closed_forms_bit_identical(name, fab):
    jf = FABRICS[fab]
    for p in PS:
        if name in POW2_FUNCS and p & (p - 1):
            continue
        for b in BS:
            _same(_fn(name, True)(p, b, _port(jf)),
                  _fn(name, False)(p, b, jf))


@pytest.mark.parametrize("fab", sorted(FABRICS))
def test_allreduce_and_launch_counts_bit_identical(fab):
    jf = FABRICS[fab]
    for p in PS:
        for b in BS:
            for pattern in j_pat.ALLREDUCE_PATTERNS:
                if pattern == "tree" and p & (p - 1):
                    continue
                _same(t_pat.t_allreduce(pattern, p, b, _port(jf)),
                      j_pat.t_allreduce(pattern, p, b, jf))
            _same(t_pat.t_star(p, b, _port(jf), refined=False),
                  j_pat.t_star(p, b, jf, refined=False))
            _same(t_pat.t_two_phase(p, b, _port(jf), s=2),
                  j_pat.t_two_phase(p, b, jf, s=2))
            _same(t_pat.t_reduce_then_broadcast(123.5, p, b, _port(jf)),
                  j_pat.t_reduce_then_broadcast(123.5, p, b, jf))
    for op, pats in (("allreduce", j_pat.ALLREDUCE_PATTERNS),
                     ("allgather", j_pat.ALLGATHER_PATTERNS),
                     ("all_to_all", j_pat.ALL_TO_ALL_PATTERNS),
                     ("reduce", j_pat.REDUCE_PATTERNS),
                     ("broadcast", j_pat.BROADCAST_PATTERNS),
                     ("reduce_scatter", j_pat.REDUCE_SCATTER_PATTERNS)):
        for alg in tuple(pats) + ("autogen",):
            for p in PS:
                _same(t_pat.launch_count(op, alg, p),
                      j_pat.launch_count(op, alg, p))


def test_pattern_tables_and_tpu_constants_match():
    for name in ("ALLGATHER_PATTERNS", "ALLREDUCE_PATTERNS",
                 "ALL_TO_ALL_PATTERNS", "BROADCAST_PATTERNS",
                 "REDUCE_PATTERNS", "REDUCE_SCATTER_PATTERNS"):
        ours, ref = getattr(t_pat, name), getattr(j_pat, name)
        if isinstance(ref, dict):
            ours = {k: f.__name__ for k, f in ours.items()}
            ref = {k: f.__name__ for k, f in ref.items()}
        assert ours == ref, name
    assert t_pat.MXU_MACS_PER_CYCLE == j_pat.MXU_MACS_PER_CYCLE
    assert dataclasses.asdict(t_model.TPU_V5E_AXIS) == \
        dataclasses.asdict(j_model.TPU_V5E_AXIS)
    assert dataclasses.asdict(t_model.WSE2) == dataclasses.asdict(
        j_model.WSE2)


@pytest.mark.parametrize("fab", sorted(FABRICS))
def test_fused_and_2d_closed_forms_bit_identical(fab):
    jf = FABRICS[fab]
    for m, k, n in ((8, 64, 16), (4096, 1024, 4096), (8192, 2560, 7168)):
        _same(t_pat.t_matmul(m, k, n), j_pat.t_matmul(m, k, n))
        for p in (2, 4, 8, 16):
            b = max(1, m * n * 2 // 512)
            t_mm = j_pat.t_matmul(m, k, n)
            _same(t_pat.t_fused_matmul_rs(p, b, t_mm, _port(jf)),
                  j_pat.t_fused_matmul_rs(p, b, t_mm, jf))
    for m, n in ((2, 2), (2, 4), (4, 4), (3, 5), (8, 8)):
        for b in BS:
            for fname in ("t_broadcast_2d", "t_snake_reduce",
                          "t_lower_bound_2d"):
                _same(getattr(t_pat, fname)(m, n, b, _port(jf)),
                      getattr(j_pat, fname)(m, n, b, jf))
            for pattern in ("chain", "two_phase", "star"):
                for fname in ("t_xy_reduce", "t_xy_allreduce",
                              "t_reduce_bcast_2d"):
                    _same(getattr(t_pat, fname)(pattern, m, n, b,
                                                _port(jf)),
                          getattr(j_pat, fname)(pattern, m, n, b, jf))
            _same(t_sel.predict_allreduce_2d(m, n, b, _port(jf)),
                  j_sel.predict_allreduce_2d(m, n, b, jf))


# ------------------------------- autogen -------------------------------- #
@pytest.mark.parametrize("p_max", [1, 2, 10, 16, 64])
def test_autogen_tables_bit_identical(p_max):
    jt = j_autogen.compute_tables(p_max, use_cache=False)
    tt = t_autogen.compute_tables(p_max, use_cache=False)
    assert tt.pairs == jt.pairs
    assert tt.pair_index == jt.pair_index
    np.testing.assert_array_equal(tt.energy, jt.energy)
    np.testing.assert_array_equal(tt.split, jt.split)
    assert tt.energy.dtype == jt.energy.dtype
    assert tt.split.dtype == jt.split.dtype


def test_autogen_table_cache_survives_threads_building_it_at_once(
        tmp_path, monkeypatch):
    """Eight threads of one process (a local grid's ranks) build the same
    table into one fresh cache directory at once: none raises (each
    writes its own temporary file before the rename), and the cached
    file loads as the table."""
    import threading

    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    start = threading.Barrier(8)
    errors, tables = [], []

    def build():
        try:
            start.wait()
            tables.append(t_autogen.compute_tables(64))
        except Exception as exc:        # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(tables) == 8
    assert [p.name for p in tmp_path.iterdir()] == [
        "autogen_P64_D63_C63_ds12_cs16.npz"]
    cached = t_autogen.compute_tables(64)
    fresh = t_autogen.compute_tables(64, use_cache=False)
    np.testing.assert_array_equal(cached.energy, fresh.energy)
    np.testing.assert_array_equal(cached.split, fresh.split)


@pytest.mark.parametrize("fab", sorted(FABRICS))
@pytest.mark.parametrize("p", [2, 3, 5, 8, 13, 16, 64])
def test_autogen_trees_and_rounds_bit_identical(p, fab):
    jf = FABRICS[fab]
    jt = j_autogen.compute_tables(p, use_cache=False)
    tt = t_autogen.compute_tables(p, use_cache=False)
    for b in (1, 4, 32, 256, 4096, 65536, 1 << 20):
        _same(t_autogen.t_autogen(p, b, _port(jf), tt),
              j_autogen.t_autogen(p, b, jf, jt))
        jtree = j_autogen.autogen_tree(p, b, jf, jt)
        ttree = t_autogen.autogen_tree(p, b, _port(jf), tt)
        assert ttree.parent == jtree.parent
        assert ttree.children == jtree.children
        assert ttree.label == jtree.label
        assert ttree.to_rounds() == jtree.to_rounds()
        _same(dataclasses.astuple(ttree.cost_terms(b)),
              dataclasses.astuple(jtree.cost_terms(b)))
        _same(t_pat.t_autogen_tree(ttree, b, _port(jf)),
              j_pat.t_autogen_tree(jtree, b, jf))


def test_autogen_cache_round_trip_in_the_ports_namespace(tmp_path):
    """A cached table reads back equal, from the port's own directory;
    the JAX package's directory stays empty."""
    first = t_autogen.compute_tables(12)
    files = os.listdir(tmp_path / "torch")
    assert files and all(f.startswith("autogen_P12") for f in files)
    assert not (tmp_path / "jax").exists()
    again = t_autogen.compute_tables(12)
    np.testing.assert_array_equal(again.energy, first.energy)
    np.testing.assert_array_equal(again.split, first.split)


def test_cache_dir_is_not_the_references(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR")
    monkeypatch.delenv("REPRO_CACHE_DIR")
    port, ref = t_autogen.cache_dir(), j_autogen.cache_dir()
    assert os.path.realpath(port) != os.path.realpath(ref)
    monkeypatch.setenv("REPRO_CACHE_DIR", "/elsewhere")
    assert t_autogen.cache_dir() == port       # never the reference's var


# ------------------------------ lower bound ----------------------------- #
@pytest.mark.parametrize("fab", sorted(FABRICS))
def test_lower_bounds_bit_identical(fab):
    jf = FABRICS[fab]
    jlb = j_lb.compute_lb_energy(128, use_cache=False)
    tlb = t_lb.compute_lb_energy(128, use_cache=False)
    np.testing.assert_array_equal(tlb, jlb)
    for p in PS:
        for b in BS:
            _same(t_lb.t_lower_bound(p, b, _port(jf), tlb),
                  j_lb.t_lower_bound(p, b, jf, jlb))


# ------------------------------- selector ------------------------------- #
@pytest.mark.parametrize("fab", sorted(FABRICS))
@pytest.mark.parametrize("op", j_sel.COLLECTIVE_OPS)
def test_selector_predictions_and_argmins_bit_identical(op, fab):
    jf = FABRICS[fab]
    for p in (2, 3, 4, 5, 8, 16, 64):
        jt = j_autogen.compute_tables(p, use_cache=False)
        tt = t_autogen.compute_tables(p, use_cache=False)
        for b in BS:
            for include in (False, True):
                _same(t_sel.predict_collective(op, p, b, _port(jf),
                                               include_autogen=include,
                                               tables=tt),
                      j_sel.predict_collective(op, p, b, jf,
                                               include_autogen=include,
                                               tables=jt))
            ts = t_sel.best_collective(op, p, b, _port(jf), tables=tt)
            js = j_sel.best_collective(op, p, b, jf, tables=jt)
            assert ts.name == js.name
            _same(ts.predicted_cycles, js.predicted_cycles)
            _same(ts.all_predictions, js.all_predictions)


@pytest.mark.parametrize("fab", sorted(FABRICS))
def test_optimality_ratios_and_heatmaps_bit_identical(fab):
    jf = FABRICS[fab]
    bvals = [1, 16, 256, 4096]
    for p in (4, 16, 64):
        _same(t_sel.optimality_ratios(p, bvals, _port(jf)),
              j_sel.optimality_ratios(p, bvals, jf))
    assert t_sel.heatmap_1d_allreduce(bvals, [4, 8, 16], _port(jf)) == \
        j_sel.heatmap_1d_allreduce(bvals, [4, 8, 16], jf)
    assert t_sel.heatmap_2d_allreduce(bvals, [2, 4], _port(jf)) == \
        j_sel.heatmap_2d_allreduce(bvals, [2, 4], jf)


# ------------------------------- schedule ------------------------------- #
@pytest.mark.parametrize("p", [2, 4, 7, 8, 16, 33])
def test_fixed_trees_bit_identical(p):
    builders = ["star_tree", "chain_tree", "two_phase_tree"]
    if p & (p - 1) == 0:
        builders.append("binary_tree")
    for name in builders:
        jt = getattr(j_sched, name)(p)
        tt = getattr(t_sched, name)(p)
        assert tt.parent == jt.parent and tt.children == jt.children
        assert tt.to_rounds() == jt.to_rounds()
        for b in BS:
            _same(dataclasses.astuple(tt.cost_terms(b)),
                  dataclasses.astuple(jt.cost_terms(b)))
            for fab in FABRICS.values():
                _same(tt.cost_terms(b).cycles(_port(fab)),
                      jt.cost_terms(b).cycles(fab))
                assert tt.cost_terms(b).dominant_term(_port(fab)) == \
                    jt.cost_terms(b).dominant_term(fab)


@pytest.mark.parametrize("seed", range(6))
def test_random_trees_bit_identical(seed):
    """test_schedule.py's random pre-order trees (a seeded stream in
    place of hypothesis): rounds and cost terms agree."""
    rng = random.Random(seed)
    for _ in range(8):
        p = rng.randint(2, 40)
        jt = random_pre_order_tree(p, random.Random(seed * 1000 + p))
        tt = t_sched.ReduceTree(list(jt.parent),
                                [list(c) for c in jt.children],
                                root=jt.root, label=jt.label)
        tt.validate()
        assert tt.to_rounds() == jt.to_rounds()
        for b in (1, 4, 1000):
            _same(dataclasses.astuple(tt.cost_terms(b)),
                  dataclasses.astuple(jt.cost_terms(b)))


def test_snake_tree_bit_identical():
    for m, n in ((2, 2), (3, 4), (4, 4)):
        jt, tt = j_sched.snake_tree(m, n), t_sched.snake_tree(m, n)
        assert tt.parent == jt.parent and tt.to_rounds() == jt.to_rounds()
        _same(dataclasses.astuple(tt.cost_terms(64)),
              dataclasses.astuple(jt.cost_terms(64)))


# -------------------------------- model --------------------------------- #
@pytest.mark.parametrize("spec", ["pod=slow", "pod=dcn,data=fast",
                                  "pod=0.5", "default=slow,pod=dcn"])
def test_fabric_topology_specs_bit_identical(spec):
    jt = j_model.parse_fabric_topology(spec)
    tt = t_model.parse_fabric_topology(spec)
    assert tt.name == jt.name and tt.describe() == jt.describe()
    assert dataclasses.asdict(tt.default) == dataclasses.asdict(jt.default)
    assert [(a, dataclasses.asdict(f)) for a, f in tt.axis_fabrics] == \
        [(a, dataclasses.asdict(f)) for a, f in jt.axis_fabrics]
    for axis in (None, "pod", "data", ("pod", "data")):
        assert dataclasses.asdict(tt.for_axis(axis)) == \
            dataclasses.asdict(jt.for_axis(axis))
