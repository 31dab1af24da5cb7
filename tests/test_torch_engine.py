"""The port's CollectiveEngine against the reference's: every decision
(algorithm, predicted price, candidate prices, Auto-Gen rounds) must be
bit-identical for every op over P = 2..16 and a byte sweep; the cache
counters, the persisted decision cache (in the port's own namespace)
and the fused matmul + reduce-scatter prices must behave as the
reference's do.  Decisions need no devices, so both engines run in this
process."""

import json
import os

import pytest
import torch

import repro.collectives.engine as j_engine
import repro.core.model as j_model
import repro_torch.collectives.api as t_api
import repro_torch.collectives.engine as t_engine
import repro_torch.core.model as t_model
from repro_torch.collectives import run_local
from torch_util import record_engines

OPS = ("reduce", "allreduce", "reduce_scatter", "allgather", "broadcast",
       "all_to_all")
NBYTES = (4, 512, 768, 4096, 65536, 262144, 1 << 20, 4 << 20, 64 << 20)


@pytest.fixture(autouse=True)
def _private_caches(tmp_path, monkeypatch):
    """Each test persists under its own cache directories, and flushes
    every engine it made before they are unset."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "torch"))
    made = record_engines(monkeypatch)
    yield
    for eng in made:
        eng.flush()


def _engines(persist=False):
    return (t_engine.CollectiveEngine(persist=persist, device="cpu"),
            j_engine.CollectiveEngine(persist=persist))


def _same_stats(teng, jeng):
    """The port keeps the reference's counters, the planner's
    (``plan_hits`` / ``plan_misses``) included."""
    assert list(teng.stats) == list(jeng.stats)
    assert teng.stats == jeng.stats


def _same_decision(td, jd):
    assert td.op == jd.op and td.p == jd.p and td.nbytes == jd.nbytes
    assert td.algorithm == jd.algorithm, (td, jd)
    assert td.predicted == jd.predicted
    assert td.predictions == jd.predictions
    assert list(td.predictions) == list(jd.predictions)
    assert td.rounds == jd.rounds


@pytest.mark.parametrize("op", OPS)
def test_select_bit_identical_to_reference(op):
    teng, jeng = _engines()
    for p in range(2, 17):
        for nbytes in NBYTES:
            _same_decision(teng.select(op, nbytes, p),
                           jeng.select(op, nbytes, p))
    _same_stats(teng, jeng)


@pytest.mark.parametrize("spec", ["pod=slow", "data=0.25"])
def test_select_with_axis_fabrics_bit_identical(spec):
    """A non-default axis fabric enters the key with ``|f=`` and prices
    the candidates, as in the reference."""
    jtopo = j_model.parse_fabric_topology(spec)
    ttopo = t_model.parse_fabric_topology(spec)
    teng = t_engine.CollectiveEngine(ttopo, persist=False, device="cpu")
    jeng = j_engine.CollectiveEngine(jtopo, persist=False)
    assert teng._fabric_tag() == jeng._fabric_tag()
    for axis in ("pod", "data"):
        for op in OPS:
            for nbytes in (4096, 1 << 20):
                _same_decision(
                    teng.select(op, nbytes, 8,
                                fabric=teng.topology.for_axis(axis)),
                    jeng.select(op, nbytes, 8,
                                fabric=jeng.topology.for_axis(axis)))
    assert sorted(d.nbytes for d in teng.decision_table()) == \
        sorted(d.nbytes for d in jeng.decision_table())


@pytest.mark.parametrize("p", [2, 3, 8, 16])
def test_tree_rounds_and_forced_resolve_bit_identical(p):
    teng, jeng = _engines()
    for b in (1, 8, 2048, 131072):
        assert teng.tree_rounds(p, b) == jeng.tree_rounds(p, b)
    for op in ("reduce", "reduce_scatter", "allgather", "broadcast"):
        for alg in ("autogen", "autogen_pipelined", "chain", "oneshot"):
            assert teng._resolve(op, 1 << 16, p, alg) == \
                jeng._resolve(op, 1 << 16, p, alg)
    _same_stats(teng, jeng)


@pytest.mark.parametrize("m,k,n,p,dtype_bytes", [
    (8192, 2560, 7168, 8, 2),        # yi-34b TP-8 down-projection, bf16
    (4096, 1024, 4096, 4, 4),
    (64, 32, 48, 8, 4),              # tiny: the serial path wins
    (16, 8, 8, 2, 2),
])
def test_fused_matmul_rs_prices_bit_identical(m, k, n, p, dtype_bytes):
    teng, jeng = _engines()
    assert teng.price_fused_matmul_rs(m, k, n, p, dtype_bytes=dtype_bytes) \
        == jeng.price_fused_matmul_rs(m, k, n, p, dtype_bytes=dtype_bytes)


def test_stats_hits_misses_and_clear_cache_match_reference():
    teng, jeng = _engines()
    for eng in (teng, jeng):
        eng.select("allreduce", 4096, 8)
        eng.select("allreduce", 4096, 8)
        eng.select("reduce", 1 << 16, 8)
        eng.select("reduce", 1 << 16, 8, topo=(2, 4))
        eng.select("allreduce", 4096, 1)          # identity: uncounted
        eng.clear_cache()
        eng.select("allreduce", 4096, 8)
    _same_stats(teng, jeng)
    assert teng.stats["hits"] == 1 and teng.stats["misses"] == 4
    assert teng.stats_snapshot() == teng.stats


def test_local_ranks_share_one_engine_one_miss_then_hits():
    """Under LocalComm the P rank threads share the engine: one call of
    an op is 1 miss and P-1 hits, and every rank runs the same
    algorithm."""
    eng = t_engine.CollectiveEngine(persist=False, device="cpu")
    xs = [torch.full((64, 4), float(r)) for r in range(8)]
    outs = run_local(lambda c: eng.allreduce_inside(xs[c.rank], c), 8,
                     "cpu")
    assert eng.stats["misses"] == 1 and eng.stats["hits"] == 7
    assert eng.stats["latency_dispatches"] == 8     # oneshot on each rank
    for o in outs:
        torch.testing.assert_close(o, torch.full((64, 4), 28.0),
                                   rtol=0, atol=0)


def test_persisted_decisions_load_in_a_fresh_engine(tmp_path):
    teng = t_engine.CollectiveEngine(persist=True, device="cpu")
    jeng = j_engine.CollectiveEngine(persist=True)
    for eng in (teng, jeng):
        for op in OPS:
            eng.select(op, 1 << 16, 8)
        eng.flush()
    tfiles = os.listdir(tmp_path / "torch")
    jfiles = os.listdir(tmp_path / "jax")
    decision_files = [f for f in tfiles if f.startswith("engine_decisions")]
    assert decision_files == [f for f in jfiles
                              if f.startswith("engine_decisions")]
    with open(tmp_path / "torch" / decision_files[0]) as f:
        tp = json.load(f)
    with open(tmp_path / "jax" / decision_files[0]) as f:
        jp = json.load(f)
    assert tp["plans"] == {}                # no multi-axis plan made
    assert tp == jp                         # the same v3 layout and values

    again = t_engine.CollectiveEngine(persist=True, device="cpu")
    for op in OPS:
        _same_decision(again.select(op, 1 << 16, 8),
                       jeng.select(op, 1 << 16, 8))
    assert again.stats["persisted_loads"] == len(OPS)
    assert again.stats["misses"] == 0 and again.stats["hits"] == len(OPS)


def test_port_never_reads_the_references_cache(tmp_path, monkeypatch):
    """Decisions the JAX engine persisted are invisible to the port (and
    the reverse), even with both variables pointing at one directory's
    siblings: the port reads only REPRO_TORCH_CACHE_DIR."""
    jeng = j_engine.CollectiveEngine(persist=True)
    jeng.select("allreduce", 4096, 8)
    jeng.flush()
    teng = t_engine.CollectiveEngine(persist=True, device="cpu")
    teng.select("allreduce", 4096, 8)
    assert teng.stats["persisted_loads"] == 0
    assert teng.stats["misses"] == 1
    teng.select("broadcast", 12345, 8)
    teng.flush()
    (name,) = [f for f in os.listdir(tmp_path / "jax")
               if f.startswith("engine_decisions")]
    with open(tmp_path / "jax" / name) as f:
        assert list(json.load(f)["decisions"]) == ["allreduce|t=8|B=4096"]
    with open(tmp_path / "torch" / name) as f:
        assert "broadcast|t=8|B=12345" in json.load(f)["decisions"]
    jeng2 = j_engine.CollectiveEngine(persist=True)
    jeng2.select("reduce", 4096, 8)
    assert jeng2.stats["persisted_loads"] == 1     # only its own decision


def test_calibrated_topology_restores_from_the_ports_cache_only(tmp_path):
    calibrated = t_model.FabricTopology(
        default=t_model.TPU_V5E_AXIS,
        axis_fabrics=(("pod", t_model.Fabric("tpu_v5e_axis_pod", 352.0, 1.0,
                                             link_bw=0.25,
                                             multicast=False)),),
        name="tpu_v5e_axis_calibrated")
    eng = t_engine.CollectiveEngine(calibrated, persist=True, device="cpu")
    eng.select("allreduce", 4096, 8)
    eng.flush()
    found = t_engine.find_calibrated_topology()
    assert found == calibrated
    assert j_engine.find_calibrated_topology() is None
    t_api._ENGINES.clear()
    try:
        restored = t_api.get_engine(device="cpu")
        assert restored.topology == calibrated
        assert t_api.get_engine(device="cpu") is restored
    finally:
        t_api._ENGINES.clear()


@pytest.mark.parametrize("value", ["0", "false", "no", "", "FALSE"])
def test_restore_opt_out_keeps_the_stock_constants(tmp_path, monkeypatch,
                                                   value):
    """ROADMAP C21: a calibration persisted in the port's cache directory
    is not restored under ``REPRO_TORCH_RESTORE_TOPOLOGY=0`` (or false,
    no, empty), as the reference's ``REPRO_RESTORE_TOPOLOGY``; any other
    value restores it."""
    eng = t_engine.CollectiveEngine(persist=True, device="cpu")
    topo = eng.calibrate(measurements={
        "pod": [(nb, 1e-6 + nb * 4e-12) for nb in (4096, 1 << 20)],
        "data": [(nb, 1e-6 + nb * 1e-12) for nb in (4096, 1 << 20)]})
    eng.select("allreduce", 4096, 8)
    eng.flush()
    assert topo.name.endswith("_calibrated")
    monkeypatch.setenv("REPRO_TORCH_RESTORE_TOPOLOGY", "1")
    assert t_engine.find_calibrated_topology() == topo
    monkeypatch.setenv("REPRO_TORCH_RESTORE_TOPOLOGY", value)
    assert t_engine.find_calibrated_topology() is None
    t_api._ENGINES.clear()
    try:
        stock = t_api.get_engine(device="cpu")
        assert stock.topology == t_model.FabricTopology.uniform(
            t_model.TPU_V5E_AXIS)
    finally:
        t_api._ENGINES.clear()


def test_engine_defaults_to_cuda_and_refuses_other_devices():
    if torch.cuda.is_available():
        pytest.skip("the no-GPU default is what is tested here")
    with pytest.raises(RuntimeError, match="no GPU"):
        t_engine.CollectiveEngine(persist=False)
    with pytest.raises(RuntimeError, match="no GPU"):
        t_api.get_engine()
    with pytest.raises(RuntimeError, match="no GPU"):
        t_api.select_algorithm(4096, 8)
    with pytest.raises(RuntimeError, match="no GPU"):
        run_local(lambda c: c.rank, 2)


def test_api_functions_match_engine_calls():
    xs = [torch.arange(16.0).reshape(8, 2) + r for r in range(4)]
    outs = run_local(lambda c: (
        t_api.allreduce(xs[c.rank], c, "ring"),
        t_api.reduce_scatter(xs[c.rank], c, "ring"),
        t_api.allgather(xs[c.rank], c, "ring"),
        t_api.broadcast(xs[c.rank], c, 2, "doubling"),
        t_api.all_to_all(xs[c.rank], c, "ring"),
        t_api.reduce_to_root(xs[c.rank], c)), 4, "cpu")
    total = sum(xs)
    for r, (ar, rs, ag, bc, a2a, red) in enumerate(outs):
        assert torch.equal(ar, total)
        assert torch.equal(rs, total[2 * r:2 * r + 2])
        assert torch.equal(ag, torch.cat(xs))
        assert torch.equal(bc, xs[2])
        assert torch.equal(a2a, torch.cat([x[2 * r:2 * r + 2] for x in xs]))
        if r == 0:
            assert torch.equal(red, total)
    assert t_api.select_algorithm(4096, 8, device="cpu") == \
        j_engine.CollectiveEngine(persist=False).select(
            "allreduce", 4096, 8).algorithm
