"""Observability in the port against the reference's (ROADMAP A.7 (a)).

* The metrics registry, the model-error monitor and the telemetry
  export are numpy: the same sequence of operations (or the same span
  list) through both packages gives equal ``export_json``, equal
  Prometheus text, equal ``report()`` and equal ``render_table()``
  (anchors: ``tests/test_obs.py``).
* Spans: the Chrome trace round-trips, and a port trace loads in the
  reference's tools and back; the tracer's contract (no-op when off,
  ``max_spans``, thread-local nesting, ``validate_spans``) as the
  reference's; a port span is always ``mode="eager"`` (ROADMAP C22).
* Span decisions: the engine's spans on 8 CPU rank threads carry the
  decision, plan (``describe()``, ``n_chunks``, ``predicted``) and phase
  labels the reference engine's host side gives for the same (op, axis
  sizes, bytes) (``_select_meta`` / ``plan_multi`` / ``_phase_names``),
  and every rank's span its rank.
* Replay fills ``measured_s`` into spans without one and tags it.
* The CLIs: ``launch/train.py --dp`` and ``launch/serve.py --dp`` under
  ``torch.distributed.run`` on 2 gloo processes with ``--trace``,
  ``--obs-report`` and ``--metrics-out`` write one trace and one
  registry dump a process, which validate."""

import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.collectives.engine as j_engine
import repro.obs.model_error as j_me
import repro.obs.registry as j_reg
import repro.obs.replay as j_replay
import repro.obs.trace as j_trace
import repro.serving.telemetry as j_tel
import repro_torch.collectives.engine as t_engine
import repro_torch.obs.model_error as t_me
import repro_torch.obs.registry as t_reg
import repro_torch.obs.replay as t_replay
import repro_torch.obs.trace as t_trace
import repro_torch.serving.telemetry as t_tel
from repro_torch.collectives import run_local, run_local_grid
from torch_util import record_engines

ROOT = Path(__file__).resolve().parents[1]


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


@pytest.fixture
def tracer():
    """A fresh enabled port tracer installed as the process tracer."""
    tr = t_trace.Tracer(enabled=True)
    prev = t_trace.set_tracer(tr)
    yield tr
    t_trace.set_tracer(prev)


# ------------------------------ registry ------------------------------ #
def _ops_counter(reg):
    c = reg.counter("requests", help="requests served")
    c.inc()
    c.inc(2.5)
    reg.counter("requests", labels={"code": "200"}).inc(3)


def _ops_gauges(reg):
    reg.gauge("occupancy", labels={"pool": "kv"}).set(0.5)
    reg.gauge("occupancy", labels={"pool": "host"}).set(0.9)
    reg.gauge("fleet_rejected_by_tenant",
              labels={"tenant": 'a"b\\c\nd'}).set(2)
    g = reg.gauge("depth")
    g.set(4)
    g.inc(1.5)


def _ops_histogram(reg):
    h = reg.histogram("lat", help="latency")
    for v in range(1, 101):
        h.observe(float(v))
    small = reg.histogram("small", max_samples=8)
    rng = np.random.default_rng(3)
    for v in rng.normal(size=50):       # past the reservoir bound
        small.observe(float(v))
    reg.histogram("empty")


def _ops_collector(reg):
    calls = []

    def collect(r):
        calls.append(1)
        r.gauge("fresh").set(len(calls))

    reg.register_collector("src", collect)
    reg.snapshot()
    reg.register_collector("src2", lambda r: r.counter("c2").inc())
    reg.unregister_collector("src2")


@pytest.mark.parametrize("ops", [_ops_counter, _ops_gauges, _ops_histogram,
                                 _ops_collector],
                         ids=["counter", "gauges", "histogram", "collector"])
def test_registry_exports_equal_the_references(ops):
    t, j = t_reg.MetricsRegistry(), j_reg.MetricsRegistry()
    ops(t)
    ops(j)
    assert t.export_json() == j.export_json()
    assert t.export_json_str() == j.export_json_str()
    assert t.export_prometheus() == j.export_prometheus()
    assert t_reg.validate_export(t.export_json()) == []


def test_registry_refusals_and_validation_as_the_reference():
    for mod in (t_reg, j_reg):
        reg = mod.MetricsRegistry()
        reg.counter("n")
        with pytest.raises(TypeError):
            reg.gauge("n")
        with pytest.raises(ValueError):
            reg.counter("m").inc(-1)
    blobs = [{"schema": "nope"}, [1, 2], {"schema": t_reg.EXPORT_SCHEMA},
             {"schema": t_reg.EXPORT_SCHEMA, "counters": {"a": "NaN-ish"},
              "gauges": [], "histograms": {"h": {"sum": 1.0}}}]
    for blob in blobs:
        assert t_reg.validate_export(blob) == j_reg.validate_export(blob)
        assert t_reg.validate_export(blob)
    assert t_reg.EXPORT_SCHEMA == j_reg.EXPORT_SCHEMA


def test_registry_snapshot_is_an_atomic_copy():
    reg = t_reg.MetricsRegistry()
    g = reg.gauge("x")
    g.set(1)
    snap = reg.snapshot()
    g.set(2)
    assert snap["gauges"]["x"] == 1


def test_engine_stats_export_equals_the_references():
    teng = t_engine.CollectiveEngine(persist=False, device="cpu")
    jeng = j_engine.CollectiveEngine(persist=False)
    for eng in (teng, jeng):
        eng.select("allreduce", 1 << 20, 8)
        eng.select("allreduce", 1 << 20, 8)
        eng.plan_multi("allreduce", ("pod", "data"), (2, 4), 1 << 16)
    treg, jreg = t_reg.MetricsRegistry(), j_reg.MetricsRegistry()
    t_reg.export_engine_stats(teng, treg)
    j_reg.export_engine_stats(jeng, jreg)
    assert treg.export_json() == jreg.export_json()
    assert treg.export_prometheus() == jreg.export_prometheus()


class _Allocator:
    num_used, num_evictable, num_free, evictions = 3, 2, 11, 4
    capacity, occupancy = 16, 0.3125

    @staticmethod
    def internal_fragmentation(block_usage):
        return 5


class _PrefixCache:
    hits, misses, inserts = 7, 2, 9

    def __len__(self):
        return 6


@pytest.mark.parametrize("cache", [True, False])
def test_prefix_cache_export_equals_the_references(cache):
    server = type("Server", (), {"allocator": _Allocator(),
                                 "prefix_cache": (_PrefixCache() if cache
                                                  else None)})()
    treg, jreg = t_reg.MetricsRegistry(), j_reg.MetricsRegistry()
    t_reg.export_prefix_cache_stats(server, treg)
    j_reg.export_prefix_cache_stats(server, jreg)
    assert treg.export_json() == jreg.export_json()
    assert treg.export_prometheus() == jreg.export_prometheus()


@pytest.mark.parametrize("ttfts", [0, 3, t_tel.TTFT_LOW_CONFIDENCE + 1])
def test_telemetry_export_equals_the_references(ttfts):
    """``export_to_registry`` of the same telemetry (a fixed clock, the
    same records) through both packages."""
    regs = []
    for tel_mod, reg_mod in ((t_tel, t_reg), (j_tel, j_reg)):
        tel = tel_mod.Telemetry(clock=iter(range(1000)).__next__)
        for i in range(ttfts):
            tel.record_submit()
            tel.record_first_token(0.0)
            tel.record_tokens(3)
        snap = tel.snapshot(queue_depth=2, active=1, allocator=_Allocator,
                            block_usage=[3, 1])
        reg = reg_mod.MetricsRegistry()
        tel_mod.export_to_registry(snap, reg)
        regs.append(reg)
    assert regs[0].export_json() == regs[1].export_json()
    assert regs[0].export_prometheus() == regs[1].export_prometheus()
    assert t_reg.validate_export(regs[0].export_json()) == []


# ------------------------------ model error --------------------------- #
def _feed_anchor_then_err(mon, err, n=32, predicted=1000.0, scale=1e-6):
    for _ in range(mon.min_samples):
        mon.observe("allreduce", "2x4", 1 << 20, predicted,
                    predicted * scale)
    for i in range(n):
        mon.observe("allreduce", "2x4", 1 << 20, predicted,
                    predicted * scale * (1.0 + err * (1 + i % 3) / 2))


def _feed_mixed(mon):
    rng = np.random.default_rng(7)
    for op in ("allreduce", "allgather", "all_to_all"):
        for nbytes in (64, 4096, 1 << 20, 3 << 22):
            for _ in range(12):
                pred = float(rng.uniform(10, 1e5))
                mon.observe(op, "8", nbytes, pred,
                            pred * 1e-8 * float(rng.uniform(0.9, 1.3)))
    mon.observe("allreduce", "8", 4096, 0.0, 1e-3)       # not scored
    mon.observe("allreduce", "8", 4096, 10.0, -1.0)


@pytest.mark.parametrize("kw,feed", [
    (dict(min_samples=4), lambda m: _feed_anchor_then_err(m, 0.02)),
    (dict(min_samples=4), lambda m: _feed_anchor_then_err(m, 0.10)),
    (dict(min_samples=8), lambda m: _feed_anchor_then_err(m, 1.0, n=3)),
    (dict(min_samples=2, seconds_per_cycle=1e-6),
     lambda m: _feed_anchor_then_err(m, 0.2, n=4)),
    (dict(min_samples=3, window=5, threshold=0.1), _feed_mixed),
], ids=["quiet", "drift", "too_few_scored", "explicit_scale", "mixed"])
def test_model_error_reports_equal_the_references(kw, feed):
    t, j = t_me.ModelErrorMonitor(**kw), j_me.ModelErrorMonitor(**kw)
    feed(t)
    feed(j)
    assert t.report() == j.report()
    assert t.render_table() == j.render_table()
    assert t.should_recalibrate == j.should_recalibrate
    assert t.recommendation() == j.recommendation()


def test_bytes_decile_equals_the_references():
    for nbytes in (0, 1, 9, 10, 999, 1000, 1 << 20, 10 ** 12):
        assert t_me.bytes_decile(nbytes) == j_me.bytes_decile(nbytes)
    assert t_me.DEFAULT_THRESHOLD == j_me.DEFAULT_THRESHOLD == 0.04


def _span_args():
    return [dict(op="allreduce", axes=("d",), axis_sizes=(8,),
                 bytes=1 << 16, predicted=100.0, measured_s=1e-4),
            dict(op="allreduce", axes=("d",), bytes=1 << 16,
                 predicted=100.0, measured_s=None),
            dict(op="allgather", axes=("pod", "data"), axis_sizes=(2, 4),
                 bytes=4096, predicted=50.0, measured_s=3e-5),
            dict(op="allgather", axes="data", bytes=4096, predicted=50.0,
                 measured_s=2e-5)]


def test_observe_spans_equals_the_references_and_counts_rank_0_once():
    """The same span list through both tracers and monitors gives the
    same report; the port counts a multi-rank call once, from rank 0's
    span."""
    reports = []
    for tr_mod, me_mod in ((t_trace, t_me), (j_trace, j_me)):
        tr = tr_mod.Tracer(enabled=True)
        for args in _span_args():
            with tr.span("s", **args):
                pass
        with tr.span("phase", cat=tr_mod.CAT_PHASE, op="allreduce"):
            pass
        mon = me_mod.ModelErrorMonitor(min_samples=2)
        assert mon.observe_spans(tr.spans) == 3
        reports.append((mon.report(), mon.render_table()))
    assert reports[0] == reports[1]
    tr = t_trace.Tracer(enabled=True)
    for rank in range(4):
        with tr.span("s", rank=rank, **_span_args()[0]):
            pass
    mon = t_me.ModelErrorMonitor(min_samples=2)
    assert mon.observe_spans(tr.spans) == 1
    assert mon.observed == 1 and mon.skipped == 0


# ------------------------------ trace --------------------------------- #
def test_chrome_trace_round_trips_and_crosses_to_the_reference(tmp_path,
                                                              tracer):
    with tracer.span("allreduce_multi", op="allreduce",
                     axes=("pod", "data"), bytes=4096,
                     plan="hierarchical(rs:ring->ar:ring->ag:ring)",
                     cache="miss", predicted=123.0, measured_s=0.0015,
                     mode="eager", rank=0) as root:
        for r, label in enumerate(("rs:ring@data", "ar:ring@pod")):
            with tracer.span(label, cat=t_trace.CAT_PHASE, op="allreduce",
                             phase=r):
                pass
        root.set(n_chunks=2)
    path = str(tmp_path / "trace.json")
    assert tracer.export_chrome(path) == 3
    for load in (t_trace.load_chrome_trace, j_trace.load_chrome_trace):
        loaded = load(path)
        assert [s.span_id for s in loaded] == [s.span_id
                                               for s in tracer.spans]
        assert [s.parent_id for s in loaded] == [s.parent_id
                                                 for s in tracer.spans]
        assert loaded[0].args["n_chunks"] == 2
        assert loaded[0].args["predicted"] == 123.0
    with open(path) as f:
        assert json.load(f)["metadata"]["schema"] == j_trace.TRACE_SCHEMA
    # and a reference trace loads in the port
    jtr = j_trace.Tracer(enabled=True)
    with jtr.span("ag", op="allgather", axes=("d",), bytes=8, plan=None,
                  cache="hit", predicted=1.0, measured_s=None,
                  mode="traced"):
        pass
    jtr.export_chrome(str(tmp_path / "ref.json"))
    (sp,) = t_trace.load_chrome_trace(str(tmp_path / "ref.json"))
    assert sp.args["mode"] == "traced" and sp.predicted == 1.0


def test_tracer_off_is_a_no_op_and_max_spans_drops():
    tr = t_trace.Tracer(enabled=False)
    sp = tr.span("x")
    assert sp is t_trace.NULL_SPAN
    with sp:
        sp.set(a=1)
        sp.finish_result(torch.zeros(2))
    assert tr.spans == [] and tr.current_span() is t_trace.NULL_SPAN
    tr = t_trace.Tracer(enabled=True, max_spans=1)
    with tr.span("kept"):
        pass
    with tr.span("dropped"):
        pass
    assert [s.name for s in tr.spans] == ["kept"] and tr.dropped == 1


@pytest.mark.parametrize("measure,block,measured", [
    (True, None, True), (True, False, False), (False, None, False),
    (False, True, True)])
def test_finish_result_measures_as_asked_and_is_always_eager(measure, block,
                                                            measured):
    tr = t_trace.Tracer(enabled=True, measure=measure)
    with tr.span("coll", op="allreduce") as sp:
        sp.finish_result(torch.zeros(4), block=block)
    (span,) = tr.spans
    assert span.args["mode"] == "eager"
    if measured:
        assert span.args["measured_s"] == span.dur > 0
    else:
        assert span.args["measured_s"] is None


def test_span_stack_is_thread_local(tracer):
    seen = {}

    def worker():
        with tracer.span("child_b") as sp:
            seen["parent_b"] = sp.span.parent_id

    with tracer.span("root_a") as root:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracer.span("child_a") as sp:
            seen["parent_a"] = sp.span.parent_id
    assert seen == {"parent_a": root.span.span_id, "parent_b": None}


def test_validate_spans_equals_the_references():
    good = dict(op="allreduce", axes=("d",), bytes=8, plan=None,
                cache="hit", predicted=1.0, measured_s=None, mode="eager")
    cases = [[good], [dict(op="allreduce")],
             [dict(good, predicted=None)],
             [dict(good, predicted=None, algorithm_forced=True)], []]
    for args_list in cases:
        problems = []
        for mod in (t_trace, j_trace):
            tr = mod.Tracer(enabled=True)
            for args in args_list:
                with tr.span("s", **args):
                    pass
            problems.append(mod.validate_spans(tr.spans))
        assert problems[0] == problems[1]


# ---------------------------- span decisions --------------------------- #
def _inputs(op, p, n):
    rng = np.random.default_rng(n)
    n -= n % p if op in ("reduce_scatter", "all_to_all") else 0
    return [torch.from_numpy(rng.integers(-8, 9, n).astype(np.float32))
            for _ in range(p)]


def _tops(spans):
    return [s for s in spans if s.cat == t_trace.CAT_COLLECTIVE
            and s.parent_id is None]


@pytest.mark.parametrize("op", ["reduce", "allreduce", "reduce_scatter",
                                "allgather", "broadcast", "all_to_all"])
def test_single_axis_spans_carry_the_references_decision(op, tracer):
    """8 CPU rank threads, ``auto`` at three sizes: every rank's span
    carries the reference's ``_select_meta`` decision (algorithm,
    predicted), one rank's lookup misses and seven hit, and each span
    its rank; a forced algorithm is stamped forced."""
    teng = t_engine.CollectiveEngine(persist=False, device="cpu")
    jeng = j_engine.CollectiveEngine(persist=False)
    p = 8
    for n in (64, 8192, 1 << 18):
        xs = _inputs(op, p, n)
        tracer.clear()
        run_local(lambda c: getattr(teng, op + "_inside")(xs[c.rank], c),
                  p, "cpu", axis="data")
        nbytes = xs[0].numel() * 4 * (p if op == "allgather" else 1)
        want, hit = jeng._select_meta(op, nbytes, p)
        assert not hit
        tops = _tops(tracer.spans)
        assert sorted(s.args["rank"] for s in tops) == list(range(p))
        assert sorted(s.args["cache"] for s in tops) == ["hit"] * 7 + [
            "miss"]
        for s in tops:
            assert s.name == f"{op}_inside"
            assert (s.args["op"], s.args["axes"], s.args["axis_sizes"],
                    s.args["bytes"]) == (op, ("data",), (p,), nbytes)
            assert s.args["algorithm"] == want.algorithm
            assert s.args["predicted"] == want.predicted
            assert s.args["mode"] == "eager" and s.args["plan"] is None
        assert t_trace.validate_spans(tracer.spans) == []
    tracer.clear()
    forced = {"reduce": "chain", "allreduce": "ring",
              "reduce_scatter": "ring", "allgather": "doubling",
              "broadcast": "chain", "all_to_all": "halving"}[op]
    xs = _inputs(op, p, 4096)
    run_local(lambda c: getattr(teng, op + "_inside")(xs[c.rank], c,
                                                      algorithm=forced),
              p, "cpu", axis="data")
    for s in _tops(tracer.spans):
        assert (s.args["algorithm"], s.args["cache"],
                s.args["algorithm_forced"], s.args["predicted"]) == (
                    forced, "forced", True, None)


def _wavefront(names, n_chunks):
    return [names[w - k] for w in range(len(names) + n_chunks - 1)
            for k in range(n_chunks) if 0 <= w - k < len(names)]


MULTI_CASES = [("allreduce", "auto", 1 << 10), ("allreduce", "auto", 1 << 18),
               ("allreduce", "hierarchical", 1 << 14),
               ("allreduce", "sequential_pipelined", 1 << 16),
               ("reduce_scatter", "auto", 1 << 16),
               ("reduce_scatter", "cascade_pipelined", 1 << 16),
               ("allgather", "auto", 1 << 12),
               ("allgather", "cascade", 1 << 14),
               ("all_to_all", "auto", 1 << 16),
               ("all_to_all", "hierarchical_pipelined", 1 << 16)]


@pytest.mark.parametrize("op,alg,n", MULTI_CASES)
def test_multi_axis_spans_carry_the_references_plan_and_phases(op, alg, n,
                                                              tracer):
    """A 2 x 4 (pod, data) grid of CPU rank threads: each rank's span
    carries the reference engine's ``plan_multi`` (``describe()``,
    ``n_chunks``, ``predicted``, the shape as algorithm), and its phase
    spans, nested under it, carry the reference's ``_phase_names`` in
    the wavefront order."""
    teng = t_engine.CollectiveEngine(persist=False, device="cpu")
    jeng = j_engine.CollectiveEngine(persist=False)
    axes, shape = ("pod", "data"), (2, 4)
    p = 8
    xs = _inputs(op, p, n)
    run_local_grid(lambda g: getattr(teng, op + "_multi")(
        xs[g.rank], g, axes, alg), shape, axes, "cpu")
    nbytes = xs[0].numel() * 4 * (p if op == "allgather" else 1)
    plan = jeng.plan_multi(op, axes, shape, nbytes,
                           shape=None if alg == "auto" else alg)
    names = j_engine.CollectiveEngine._phase_names(plan.steps)
    spans = tracer.spans
    tops = _tops(spans)
    assert sorted(s.args["rank"] for s in tops) == list(range(p))
    for top in tops:
        assert top.name == f"{op}_multi"
        assert (top.args["plan"], top.args["n_chunks"],
                top.args["predicted"], top.args["algorithm"]) == (
                    plan.describe(), plan.n_chunks, plan.predicted,
                    str(plan.shape))
        assert top.args["axis_sizes"] == shape
        assert top.args.get("algorithm_forced", False) == (alg != "auto")
        assert top.args["cache"] in ("hit", "miss")
        phases = [s for s in spans if s.parent_id == top.span_id
                  and s.cat == t_trace.CAT_PHASE]
        if plan.shape in ("flat", "latency", "2d_xy", "2d_snake",
                          "identity"):
            assert not phases
        else:
            assert [s.name for s in phases] == _wavefront(
                names, max(1, plan.n_chunks))
            # each phase's own collective nests under it, on this rank
            for ph in phases:
                kids = [s for s in spans if s.parent_id == ph.span_id]
                assert kids and all(s.args["rank"] == top.args["rank"]
                                    for s in kids)
    assert sorted(s.args["cache"] for s in tops).count("miss") == 1
    assert t_trace.validate_spans(spans) == []


def test_fused_span_carries_the_models_price(tracer):
    teng = t_engine.CollectiveEngine(persist=False, device="cpu")
    jeng = j_engine.CollectiveEngine(persist=False)
    rng = np.random.default_rng(2)
    p, m, k, n = 4, 8, 6, 5
    xs = [torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
          for _ in range(p)]
    ws = [torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
          for _ in range(p)]
    run_local(lambda c: teng.fused_matmul_reduce_scatter(
        xs[c.rank], ws[c.rank], c), p, "cpu", axis="model")
    price = jeng.price_fused_matmul_rs(m, k, n, p, axes="model")
    for s in _tops(tracer.spans):
        assert s.name == "fused_matmul_rs" and s.args["cache"] == "model"
        want = "fused_ring" if price["saved"] > 0 else "unfused"
        assert s.args["algorithm"] == want
        assert s.args["predicted"] == price[
            "fused" if want == "fused_ring" else "serial"]
        assert s.args["overlap_saved"] == price["saved"]


def test_engine_without_tracing_opens_no_span(tracer):
    tracer.enabled = False
    teng = t_engine.CollectiveEngine(persist=False, device="cpu")
    xs = _inputs("allreduce", 4, 256)
    run_local_grid(lambda g: teng.allreduce_multi(xs[g.rank], g,
                                                  ("pod", "data")),
                   (2, 2), ("pod", "data"), "cpu")
    assert tracer.spans == []


# ------------------------------ replay -------------------------------- #
def test_replay_fills_measured_s_and_tags_it(tracer):
    """Spans recorded without measurement get the replay's best wall,
    tagged ``measured_via="replay"``; each signature runs once, and the
    signatures equal the reference's ``span_signature``."""
    teng = t_engine.CollectiveEngine(persist=False, device="cpu")
    axes, shape = ("pod", "data"), (2, 4)
    xs = _inputs("allreduce", 8, 4096)
    shards = _inputs("allgather", 8, 512)

    def run(g):
        teng.allreduce_multi(xs[g.rank], g, axes)
        teng.allgather_inside(shards[g.rank], g.sub("data"), "ring")
        teng.reduce_inside(xs[g.rank], g.sub("data"))
        return g

    grid = run_local_grid(run, shape, axes, "cpu")[0]
    spans = tracer.spans
    coll = [s for s in spans if s.cat == t_trace.CAT_COLLECTIVE]
    assert all(s.args["measured_s"] is None for s in coll)
    for s in coll:
        assert t_replay.span_signature(s) == j_replay.span_signature(s)
    measured = t_replay.measure_spans(spans, grid, engine=teng, repeats=2)
    sigs = {t_replay.span_signature(s) for s in coll} - {None}
    assert set(measured) == sigs and len(sigs) >= 2
    for s in coll:
        if t_replay.span_signature(s) is None:
            assert s.args["measured_s"] is None      # reduce: not replayed
        else:
            assert s.args["measured_s"] == measured[
                t_replay.span_signature(s)] > 0
            assert s.args["measured_via"] == "replay"
    assert tracer.enabled and len(tracer.spans) == len(spans)
    # a second pass has nothing left to fill
    assert t_replay.measure_spans(spans, grid, engine=teng) == {}


# ------------------------------- CLIs --------------------------------- #
def _torchrun(args, tmp_path):
    # one OpenMP thread a process: torchrun's workers beside the other
    # test workers would oversubscribe the host's cores many times over
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_TORCH_CACHE_DIR=str(tmp_path / "cache"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *args, "--device", "cpu",
         "--trace", str(tmp_path / "trace.json"), "--obs-report",
         "--metrics-out", str(tmp_path / "metrics.json")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.mark.parametrize("cli", [
    ["-m", "repro_torch.launch.train", "--arch", "minicpm-2b", "--reduced",
     "--dp", "--grad-sync", "fsdp", "--steps", "2", "--batch", "4",
     "--seq", "32"],
    ["-m", "repro_torch.launch.serve", "--dp", "--requests", "4",
     "--new-tokens", "4"],
], ids=["train", "serve"])
def test_cli_obs_flags_write_valid_artifacts_per_process(cli, tmp_path):
    out = _torchrun(cli, tmp_path)
    for r in range(2):
        spans = t_trace.load_chrome_trace(
            str(tmp_path / f"trace.rank{r}.json"))
        assert t_trace.validate_spans(spans) == []
        tops = [s for s in spans if s.cat == t_trace.CAT_COLLECTIVE
                and s.parent_id is None]
        assert {s.args["rank"] for s in tops} == {r}
        assert all(s.args["measured_s"] > 0 for s in tops)
        with open(tmp_path / f"metrics.rank{r}.json") as f:
            blob = json.load(f)
        assert t_reg.validate_export(blob) == []
        assert any(k.startswith("engine_misses") for k in blob["gauges"])
        if "serve" in cli[1]:
            assert "serve_decode_steps" in blob["gauges"]
    assert len(re.findall(r"op +topo +bytes", out)) == 1     # rank 0's
    assert not (tmp_path / "trace.json").exists()
