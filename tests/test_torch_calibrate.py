"""Calibration in the port against the reference's (ROADMAP A.2.b).

The anchors are the reference's own calibration tests
(``tests/test_engine.py`` from the calibration round trip on,
``tests/test_latency.py``'s launch calibration), run here on both
engines with the same numpy inputs: the fitted constants, the
``auto`` decisions and plans after a refit, the cache file's name and
the persisted v3 ``topology`` section must be ``==``, and the refusals
must carry the reference's messages.

``measure_ppermute`` and ``calibrate(grid=)`` time shifts on a
:class:`GridComm` where the reference times a mesh: on CPU rank threads
(``run_local_grid``) and on 2 gloo processes these tests hold the
plumbing -- names, axes, every rank fitting the same constants, the
persisted topology, its restore by ``get_engine`` (and not under
``REPRO_TORCH_RESTORE_TOPOLOGY=0``), cleared decisions -- not the
constants, which describe no fabric there."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.collectives.engine as j_engine
import repro.core.model as j_model
import repro_torch.collectives.api as t_api
import repro_torch.collectives.engine as t_engine
import repro_torch.core.model as t_model
import repro_torch.core.patterns as t_pat
from repro_torch.collectives import run_local_grid
from torch_util import record_engines

ROOT = Path(__file__).resolve().parents[1]
EB = t_engine.ICI_ELEMENT_BYTES
OPS = ("reduce", "allreduce", "reduce_scatter", "allgather", "broadcast",
       "all_to_all")
NBYTES = (256, 4096, 65536, 1 << 20, 16 << 20)
#: shift sizes for the CPU grids: large enough that the copies, not the
#: barriers, set the slope
GRID_SIZES = (4096, 4 << 20, 16 << 20)


@pytest.fixture(autouse=True)
def _private_caches(tmp_path, monkeypatch):
    """Each test persists under its own cache directories, and flushes
    every engine it made before they are unset."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "torch"))
    monkeypatch.delenv("REPRO_RESTORE_TOPOLOGY", raising=False)
    monkeypatch.delenv("REPRO_TORCH_RESTORE_TOPOLOGY", raising=False)
    made = record_engines(monkeypatch)
    t_api._ENGINES.clear()
    yield
    t_api._ENGINES.clear()
    for eng in made:
        eng.flush()


def _fabrics(name, **kw):
    """The same Fabric in both packages."""
    return t_model.Fabric(name=name, **kw), j_model.Fabric(name=name, **kw)


def _engines(fabric=None, persist=True):
    """(port engine, reference engine), each persisting under its own
    package's cache directory."""
    tf, jf = fabric or (t_model.TPU_V5E_AXIS, j_model.TPU_V5E_AXIS)
    return (t_engine.CollectiveEngine(tf, persist=persist, device="cpu"),
            j_engine.CollectiveEngine(jf, persist=persist))


def _same_fabric(tf, jf):
    assert t_engine.fabric_to_dict(tf) == j_engine.fabric_to_dict(jf)


def _same_topology(tt, jt):
    assert t_engine.topology_to_dict(tt) == j_engine.topology_to_dict(jt)


def _same_cache_name(teng, jeng):
    assert (os.path.basename(teng._cache_path())
            == os.path.basename(jeng._cache_path()))


def _same_decisions(teng, jeng, ps=(4, 8)):
    for op in OPS:
        for p in ps:
            for nbytes in NBYTES:
                td, jd = teng.select(op, nbytes, p), jeng.select(op, nbytes,
                                                                 p)
                assert (td.algorithm, td.predicted, td.predictions,
                        td.rounds) == (jd.algorithm, jd.predicted,
                                       jd.predictions, jd.rounds), \
                    (op, p, nbytes)


def _same_plan(tp, jp):
    assert tp.describe() == jp.describe()
    assert (tp.shape, tp.n_chunks, tp.predicted, tp.predictions) == \
        (jp.shape, jp.n_chunks, jp.predicted, jp.predictions)
    assert tp.cost_terms == jp.cost_terms


def _synthetic_measurements(t_r: float, bw: float, cycle: float = 11.4e-9):
    """Per-axis shift timings for a link with the given constants (the
    reference test's generator)."""
    return [(nb, 2 * t_r * cycle + max(1, nb // EB) * cycle / bw)
            for nb in (1 << 12, 1 << 16, 1 << 20, 1 << 22)]


# ------------------------------ fit_fabric ----------------------------- #
@pytest.mark.parametrize("base", ["tpu_v5e_axis", "wse2"])
@pytest.mark.parametrize("ref_cycle", [None, 7.3e-9])
def test_fit_fabric_equals_reference(base, ref_cycle):
    tb = {"tpu_v5e_axis": t_model.TPU_V5E_AXIS, "wse2": t_model.WSE2}[base]
    jb = {"tpu_v5e_axis": j_model.TPU_V5E_AXIS, "wse2": j_model.WSE2}[base]
    meas = _synthetic_measurements(t_r=42.0, bw=0.5)
    tf = t_engine.fit_fabric(meas, base=tb, ref_cycle=ref_cycle)
    jf = j_engine.fit_fabric(meas, base=jb, ref_cycle=ref_cycle)
    _same_fabric(tf, jf)
    assert t_engine._fit_line(meas, EB) == j_engine._fit_line(meas, EB)
    with pytest.raises(ValueError, match=">= 2"):
        t_engine.fit_fabric(meas[:1])


# ------------------------- calibrate(measurements) --------------------- #
def test_calibration_round_trip_equals_reference():
    """A list refits one uniform Fabric (``test_calibration_round_trip``):
    the fitted constants, the stale decisions dropped, the cache file
    moved and every decision after the refit as the reference's."""
    true_t_r, cycle = 42.0, 11.4e-9
    meas = [(nb, (2 * true_t_r + nb // EB) * cycle)
            for nb in (1 << 12, 1 << 16, 1 << 20, 1 << 22)]
    teng, jeng = _engines()
    for eng in (teng, jeng):
        eng.select("allreduce", 1 << 20, 8)
    name_before = os.path.basename(teng._cache_path())
    tout, jout = teng.calibrate(measurements=meas), jeng.calibrate(
        measurements=meas)
    _same_fabric(tout, jout)
    assert tout.t_r == pytest.approx(true_t_r, rel=1e-6)
    assert teng.fabric is tout and teng.topology.is_uniform
    _same_cache_name(teng, jeng)
    assert os.path.basename(teng._cache_path()) != name_before
    for eng in (teng, jeng):
        eng.select("allreduce", 1 << 20, 8)
    assert teng.stats == jeng.stats and teng.stats["misses"] == 2
    _same_decisions(teng, jeng)


def test_per_axis_calibration_round_trip_equals_reference():
    """A dict fits one Fabric per axis on the fastest axis's time base,
    and the (2, 16) plan at 128 KiB flips to hierarchical
    (``test_per_axis_calibration_round_trip``)."""
    teng, jeng = _engines()
    _same_plan(teng.plan_multi("allreduce", ("pod", "data"), (2, 16),
                               1 << 17),
               jeng.plan_multi("allreduce", ("pod", "data"), (2, 16),
                               1 << 17))
    meas = {"pod": _synthetic_measurements(t_r=300.0, bw=1.0 / 8.0),
            "data": _synthetic_measurements(t_r=88.0, bw=1.0)}
    ttopo, jtopo = teng.calibrate(measurements=meas), jeng.calibrate(
        measurements=meas)
    assert isinstance(ttopo, t_model.FabricTopology)
    assert teng.topology is ttopo
    _same_topology(ttopo, jtopo)
    assert ttopo.for_axis("pod").t_r == pytest.approx(300.0, rel=1e-6)
    assert ttopo.for_axis("pod").link_bw == pytest.approx(1 / 8, rel=1e-6)
    _same_cache_name(teng, jeng)
    after = teng.plan_multi("allreduce", ("pod", "data"), (2, 16), 1 << 17)
    _same_plan(after, jeng.plan_multi("allreduce", ("pod", "data"),
                                      (2, 16), 1 << 17))
    assert after.shape == "hierarchical"
    for axis in ("pod", "data"):
        for op in OPS:
            for nbytes in (4096, 1 << 20):
                td = teng.select(op, nbytes, 8,
                                 fabric=teng.topology.for_axis(axis))
                jd = jeng.select(op, nbytes, 8,
                                 fabric=jeng.topology.for_axis(axis))
                assert (td.algorithm, td.predictions) == (jd.algorithm,
                                                          jd.predictions)


def test_per_axis_calibration_persists_the_references_v3_topology():
    """The v3 file records the per-axis fabrics as the reference's does
    (same name, same ``topology`` section); ``load_topology`` restores
    them, and an engine rebuilt on them serves the persisted plan."""
    teng, jeng = _engines()
    meas = {"pod": _synthetic_measurements(t_r=300.0, bw=0.25),
            "data": _synthetic_measurements(t_r=88.0, bw=1.0)}
    topo = teng.calibrate(measurements=meas)
    jeng.calibrate(measurements=meas)
    for eng in (teng, jeng):
        eng.plan_multi("allreduce", ("pod", "data"), (2, 4), 1 << 20)
        eng.flush()
    _same_cache_name(teng, jeng)
    with open(teng._cache_path()) as f:
        tpay = json.load(f)
    with open(jeng._cache_path()) as f:
        jpay = json.load(f)
    assert tpay["schema"] == jpay["schema"] == t_engine.SCHEMA_VERSION == 3
    assert tpay["topology"] == jpay["topology"]
    assert tpay["fabric"] == jpay["fabric"]
    assert tpay["plans"] == jpay["plans"]
    restored = t_engine.load_topology(teng._cache_path())
    assert restored == topo
    eng2 = t_engine.CollectiveEngine(restored, device="cpu")
    eng2.plan_multi("allreduce", ("pod", "data"), (2, 4), 1 << 20)
    assert eng2.stats["plan_hits"] == 1 and eng2.stats["plan_misses"] == 0


def test_get_engine_restores_a_calibration_and_honours_the_opt_out(
        monkeypatch):
    """``test_get_engine_auto_restores_calibrated_topology`` on the
    port: the process engine comes up on the persisted calibration, not
    under ``REPRO_TORCH_RESTORE_TOPOLOGY=0``, and an explicitly
    requested topology is never overridden."""
    teng, jeng = _engines()
    meas = {"pod": _synthetic_measurements(t_r=300.0, bw=0.25),
            "data": _synthetic_measurements(t_r=88.0, bw=1.0)}
    topo = teng.calibrate(measurements=meas)
    jtopo = jeng.calibrate(measurements=meas)
    for eng in (teng, jeng):
        eng.select("allreduce", 1 << 20, 8)
        eng.flush()
    restored = t_api.get_engine(device="cpu")
    assert restored.topology == topo and not restored.topology.is_uniform
    _same_topology(restored.topology, jtopo)
    assert t_api.get_engine(device="cpu") is restored
    t_api._ENGINES.clear()
    monkeypatch.setenv("REPRO_TORCH_RESTORE_TOPOLOGY", "0")
    stock = t_api.get_engine(device="cpu")
    assert stock.topology.is_uniform
    assert stock.topology.default == t_model.TPU_V5E_AXIS
    monkeypatch.delenv("REPRO_TORCH_RESTORE_TOPOLOGY")
    t_api._ENGINES.clear()
    explicit = t_model.FabricTopology.uniform(t_model.TPU_V5E_AXIS)
    assert t_api.get_engine(explicit, device="cpu").topology == explicit


def test_find_calibrated_topology_ignores_other_families_and_declared():
    """A WSE2 calibration never restores into a TPU engine, and a
    declared ``--fabric`` topology never restores at all, as in the
    reference."""
    teng, jeng = _engines(fabric=(t_model.WSE2, j_model.WSE2))
    meas = {"pod": _synthetic_measurements(t_r=300.0, bw=0.25),
            "data": _synthetic_measurements(t_r=88.0, bw=1.0)}
    for eng in (teng, jeng):
        eng.calibrate(measurements=meas)
        eng.select("allreduce", 1 << 20, 8)
        eng.flush()
    assert t_engine.find_calibrated_topology(
        base=t_model.TPU_V5E_AXIS) is None
    assert t_engine.find_calibrated_topology(base=t_model.WSE2) is not None
    for d in os.listdir(os.environ["REPRO_TORCH_CACHE_DIR"]):
        os.remove(os.path.join(os.environ["REPRO_TORCH_CACHE_DIR"], d))
    declared = t_engine.CollectiveEngine(
        t_model.parse_fabric_topology("pod=slow"), device="cpu")
    declared.select("allreduce", 1 << 20, 8)
    declared.flush()
    assert t_engine.find_calibrated_topology() is None


@pytest.mark.parametrize("kind", ["flat", "inverted", "empty"])
def test_noise_dominated_axis_refused_as_the_reference(kind):
    """A flat or inverted timing line (no bandwidth signal) is refused
    with the reference's message, naming the axis, and leaves the
    engine untouched; so is an empty dict."""
    sizes = (1 << 12, 1 << 16, 1 << 20, 1 << 22)
    pod = {"flat": [(nb, 1e-6) for nb in sizes],
           "inverted": [(nb, 1e-3 - nb * 1e-12) for nb in sizes]}
    meas = ({} if kind == "empty" else
            {"pod": pod[kind],
             "data": _synthetic_measurements(t_r=88.0, bw=1.0)})
    teng, jeng = _engines()
    before = teng.topology
    errors = []
    for eng in (teng, jeng):
        with pytest.raises(ValueError) as info:
            eng.calibrate(measurements=meas)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert ("empty" if kind == "empty" else "'pod'") in errors[0]
    assert teng.topology is before


def test_calibration_shifts_selection_as_the_reference():
    """``test_calibration_shifts_selection``: a slow router moves
    ``auto`` off the chain at 512 KiB over 64 ranks, on both engines."""
    for t_r in (1.0, 5e4):
        teng, jeng = _engines(_fabrics("f", t_r=t_r, store_cost=1.0),
                              persist=False)
        td = teng.select("allreduce", 1 << 19, 64)
        jd = jeng.select("allreduce", 1 << 19, 64)
        assert (td.algorithm, td.predictions) == (jd.algorithm,
                                                  jd.predictions)
        assert (td.algorithm == "chain") == (t_r == 1.0)


# --------------------------- calibrate_launch -------------------------- #
def _launch_samples(eng, t_true, s_per_cycle=2e-9):
    """The reference test's generator: closed forms at t_launch = 0 plus
    ``t_true`` cycles a launch, scaled to seconds."""
    fab = eng.topology.for_axis(None)
    samples = []
    for nbytes in (256, 4096, 65536, 1 << 20):
        for op, algos in (("allreduce", ("ring", "oneshot")),
                          ("allgather", ("ring", "doubling", "oneshot"))):
            for algo in algos:
                base = eng.select(op, nbytes, 8,
                                  fabric=fab).predictions[algo]
                launches = t_pat.launch_count(op, algo, 8)
                samples.append((op, 8, nbytes, algo,
                                s_per_cycle * (base + t_true * launches)))
    return samples


def test_calibrate_launch_recovers_injected_overhead_as_the_reference():
    teng, jeng = _engines()
    samples = _launch_samples(teng, 300.0)
    tl, jl = teng.calibrate_launch(samples), jeng.calibrate_launch(samples)
    assert tl == jl
    assert tl == pytest.approx(300.0, rel=1e-6)
    _same_topology(teng.topology, jeng.topology)
    _same_cache_name(teng, jeng)
    assert "_tl300" in teng._fabric_tag()
    c, t_launch = t_engine.fit_launch(samples)
    assert t_launch == tl and c == pytest.approx(2e-9, rel=1e-6)
    _same_decisions(teng, jeng)


def test_calibrate_launch_flips_small_payloads_to_latency_as_the_reference():
    teng, jeng = _engines()
    samples = _launch_samples(teng, 300.0)
    for eng in (teng, jeng):
        eng.calibrate_launch(samples)
    after = teng.plan_multi("allreduce", ("pod", "data"), (2, 4), 4096)
    _same_plan(after, jeng.plan_multi("allreduce", ("pod", "data"), (2, 4),
                                      4096))
    assert after.shape == "latency"


@pytest.mark.parametrize("samples", [
    [("allreduce", 8, 1 << 20, "ring", 1e-3),
     ("allreduce", 8, 1 << 10, "ring", 1e-5)],
    [("allreduce", 8, 1 << 20, "ring", 1e-3)],
    [("allreduce", 8, 1 << 20, "psum", 1e-3),
     ("allreduce", 8, 1 << 10, "ring", 1e-5)],
    [("allreduce", 8, 1 << 16, "ring", 1e-3),
     ("allreduce", 8, 1 << 22, "ring", 1e-4),
     ("allreduce", 8, 1 << 16, "oneshot", 1e-3),
     ("allreduce", 8, 1 << 22, "oneshot", 1e-4)],
], ids=["one_launch_count", "one_sample", "no_closed_form", "noise"])
def test_calibrate_launch_refusals_carry_the_references_messages(samples):
    teng, jeng = _engines()
    before = teng.topology
    errors = []
    for eng in (teng, jeng):
        with pytest.raises(ValueError) as info:
            eng.calibrate_launch(samples)
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert teng.topology is before


# -------------------- measure_ppermute / calibrate(grid) ---------------- #
def test_measure_ppermute_agrees_on_every_rank_of_a_thread_grid():
    """One shift per size on each sub-comm; every rank returns the
    slowest rank's best, so all ranks of a group hold the same list."""
    sizes = (4096, 1 << 20)
    out = run_local_grid(
        lambda g: t_engine.measure_ppermute(g.sub("data"), sizes, 2),
        (2, 4), ("pod", "data"), "cpu")
    for r, m in enumerate(out):
        assert [nb for nb, _ in m] == list(sizes)
        assert all(t > 0 for _, t in m)
        assert m == out[4 * (r // 4)], r      # the rank's row agrees


def test_calibrate_grid_on_thread_grid_fits_persists_and_restores(
        monkeypatch):
    """``calibrate(grid=)`` on a 2 x 4 (pod, data) thread grid sharing
    one engine: a per-axis topology in the reference's names, the same
    on every rank, the decisions cleared, the cache file moved; after a
    flush ``get_engine`` restores it, and not under the opt-out."""
    eng = t_engine.CollectiveEngine(device="cpu")
    eng.select("allreduce", 4096, 8)
    name_before = os.path.basename(eng._cache_path())
    topos = run_local_grid(
        lambda g: eng.calibrate(grid=g, sizes_bytes=GRID_SIZES),
        (2, 4), ("pod", "data"), "cpu")
    topo = topos[0]
    assert all(t == topo for t in topos)
    assert eng.topology == topo
    assert topo.name == "tpu_v5e_axis_calibrated"
    assert [a for a, _ in topo.axis_fabrics] == ["data", "pod"]
    assert {f.name for _, f in topo.axis_fabrics} == {
        "tpu_v5e_axis_data", "tpu_v5e_axis_pod"}
    assert min(f.link_bw for _, f in topo.axis_fabrics) <= 1.0 == max(
        f.link_bw for _, f in topo.axis_fabrics)
    assert not eng._decisions and not eng._plans
    assert os.path.basename(eng._cache_path()) != name_before
    eng.select("allreduce", 4096, 8)
    assert eng.stats["misses"] == 2
    eng.flush()
    with open(eng._cache_path()) as f:
        assert t_engine.topology_from_dict(json.load(f)["topology"]) == topo
    assert t_api.get_engine(device="cpu").topology == topo
    monkeypatch.setenv("REPRO_TORCH_RESTORE_TOPOLOGY", "0")
    t_api._ENGINES.clear()
    assert t_api.get_engine(device="cpu").topology.is_uniform


def test_calibrate_grid_measures_only_the_named_axis_and_refuses_none():
    eng = t_engine.CollectiveEngine(persist=False, device="cpu")
    topos = run_local_grid(
        lambda g: eng.calibrate(grid=g, axis="data", sizes_bytes=GRID_SIZES),
        (2, 4), ("pod", "data"), "cpu")
    assert [a for a, _ in topos[0].axis_fabrics] == ["data"]
    assert topos[0].for_axis("data").link_bw == 1.0
    with pytest.raises(ValueError, match="no axis of size > 1"):
        run_local_grid(lambda g: eng.calibrate(grid=g), (1, 1),
                       ("pod", "data"), "cpu")
    with pytest.raises(ValueError,
                       match=r"calibrate\(\) needs measurements or a grid"):
        eng.calibrate()


_GLOO_SCRIPT = textwrap.dedent(r"""
    import json, sys
    import torch.distributed as dist
    from repro_torch.collectives import (CollectiveEngine, ProcessGroupComm,
                                         ProcessGroupGrid)
    from repro_torch.collectives.engine import (measure_ppermute,
                                                topology_to_dict)

    rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    sizes = tuple(json.loads(sys.argv[4]))
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    shifts = measure_ppermute(ProcessGroupComm(device="cpu"), sizes[:2], 2)
    grid = ProcessGroupGrid((world,), ("data",), device="cpu")
    eng = CollectiveEngine(device="cpu")
    eng.select("allreduce", 4096, world)
    topo = eng.calibrate(grid=grid, sizes_bytes=sizes)
    decided = len(eng._decisions)
    eng.select("allreduce", 4096, world)
    eng.flush()
    dist.destroy_process_group()
    print("JSON" + json.dumps({"shifts": shifts, "decided": decided,
                               "topology": topology_to_dict(topo)}))
""")


def test_calibrate_grid_on_gloo_processes_agrees_and_persists(
        tmp_path, monkeypatch):
    """Two gloo processes, one a rank, each with its own engine: the
    shifts and the fitted topology are the same in both, and the
    persisted calibration restores in a later process (here, this
    one)."""
    world = 2
    cache = tmp_path / "gloo_cache"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(cache))
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SCRIPT, str(r), str(world), init,
         json.dumps(GRID_SIZES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-4000:]
    res = [json.loads([ln for ln in out.splitlines()
                       if ln.startswith("JSON")][-1][4:])
           for out, _ in logs]
    assert res[0]["shifts"] == res[1]["shifts"]
    assert [nb for nb, _ in res[0]["shifts"]] == list(GRID_SIZES[:2])
    assert res[0]["topology"] == res[1]["topology"]
    assert res[0]["decided"] == 0
    topo = t_engine.topology_from_dict(res[0]["topology"])
    assert topo.name == "tpu_v5e_axis_calibrated"
    assert [a for a, _ in topo.axis_fabrics] == ["data"]
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(cache))
    assert t_engine.find_calibrated_topology() == topo
    monkeypatch.setenv("REPRO_TORCH_RESTORE_TOPOLOGY", "no")
    assert t_engine.find_calibrated_topology() is None
