"""The port's serving fleet against the JAX package's
(``tests/test_fleet.py``'s cases, each run in both packages on the same
tiny float32 config with converted weights): routing decisions,
admission and its rejections (reason, retry-after), load signals,
arrival waves for every mode and seed, ``FleetSnapshot`` fields, the
exported gauges (names, labels, values), and per-request greedy streams
bitwise at 1, 2 and 3 replicas under every policy.  Everything is
compared exactly, wall-clock fields (TTFT, queue wait, elapsed, tok/s)
excepted; then the serve CLI's fleet flags."""

import dataclasses
import math

import jax
import numpy as np
import pytest

import repro.serving as jserving
import repro.serving.fleet as jfleet
import repro_torch.serving as tserving
import repro_torch.serving.fleet as tfleet
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import init_params as j_init
from repro_torch.configs.base import ArchConfig
from repro_torch.serving.fleet import ROUTER_POLICIES
from torch_util import port_params

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=32,
               num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
               dtype="float32")
#: wall-clock quantities: measured, not decided, so never compared
WALL = ("elapsed_s", "tok_per_s", "ttft_p50_ms", "ttft_p99_ms",
        "queue_wait_p50_ms", "ttft_ewma_s")

PKGS = {"jax": (jserving, jfleet), "port": (tserving, tfleet)}


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = JArchConfig(**TINY_KW), ArchConfig(**TINY_KW)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return {"jax": (jcfg, jp), "port": (tcfg, port_params(jp, tcfg))}


def _fleet(weights, pkg, n_replicas=2, **kw):
    cfg, params = weights[pkg]
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 8)
    if pkg == "port":
        kw["device"] = "cpu"
    return PKGS[pkg][1].FleetServer(cfg, params, n_replicas, **kw)


def _req(pkg, rid, prompt_len=8, max_new=4, rng_seed=None, **kw):
    rng = np.random.default_rng(rid if rng_seed is None else rng_seed)
    return PKGS[pkg][0].Request(
        rid=rid, prompt=rng.integers(0, TINY_KW["vocab_size"],
                                     prompt_len).astype(np.int32),
        max_new_tokens=max_new, **kw)


def _signal(pkg, replica=0, queue_depth=0, queued=0, inflight=0,
            active=0):
    return PKGS[pkg][1].LoadSignal(
        replica=replica, queue_depth=queue_depth, active=active,
        running=active, queued_prefill_tokens=queued,
        inflight_prefill_tokens=inflight, kv_blocks_live=0,
        kv_blocks_evictable=0, kv_blocks_free=8, ttft_ewma_s=None,
        queue_wait_p50_ms=None)


def _decided(obj):
    """A dataclass's fields without the wall-clock ones (recursing into
    the per-replica snapshots)."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.name in WALL:
            continue
        v = getattr(obj, f.name)
        if isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            v = tuple(_decided(x) for x in v)
        out[f.name] = v
    return out


def both(fn):
    """``fn(pkg)`` in each package: (jax's, the port's)."""
    return fn("jax"), fn("port")


# ------------------------------ routers ------------------------------- #
def test_round_robin_cycles():
    def route(pkg):
        r = PKGS[pkg][1].make_router("round_robin")
        sigs = [_signal(pkg, i) for i in range(3)]
        return [r.route(_req(pkg, i), [None] * 3, sigs) for i in range(7)]
    want, got = both(route)
    assert got == want == [0, 1, 2, 0, 1, 2, 0]


def test_least_queue_picks_least_committed_prefill():
    def route(pkg):
        r = PKGS[pkg][1].make_router("least_queue")
        cases = [[_signal(pkg, 0, queued=40),
                  _signal(pkg, 1, queued=8, inflight=8),
                  _signal(pkg, 2, queued=24)],
                 [_signal(pkg, 0, queued=8), _signal(pkg, 1, queued=8)],
                 [_signal(pkg, 0, queued=8, active=2),
                  _signal(pkg, 1, queued=8, queue_depth=1)]]
        return [r.route(_req(pkg, i), [None] * len(s), s)
                for i, s in enumerate(cases)]
    want, got = both(route)
    assert got == want == [1, 0, 1]


def test_make_router_rejects_unknown_and_cost_needs_cfg(weights):
    with pytest.raises(ValueError):
        tfleet.make_router("wishful_thinking")
    with pytest.raises(ValueError):
        tfleet.make_router("cost")
    want, got = both(lambda pkg: PKGS[pkg][1].make_router(
        "cost", weights[pkg][0]).price_per_token_s)
    assert got == want > 0
    assert tfleet.ROUTER_POLICIES == jfleet.ROUTER_POLICIES


def test_cost_router_prices_uncached_suffix(weights):
    """The cost router prefers the replica whose prefix cache holds the
    prompt's blocks; the modeled costs equal the reference's."""
    def route(pkg):
        fleet = _fleet(weights, pkg, 2, router="cost", num_blocks=32,
                       prefix_cache=True)
        warm, cold = fleet.replicas
        prompt = _req(pkg, 0, prompt_len=12).prompt
        warm.submit(PKGS[pkg][0].Request(rid=100, prompt=prompt.copy(),
                                         max_new_tokens=2))
        while warm.has_work():
            warm.step()
        req = PKGS[pkg][0].Request(rid=101, prompt=prompt.copy(),
                                   max_new_tokens=2)
        sigs = [r.load_signal() for r in fleet.replicas]
        choice = fleet.router.route(req, fleet.replicas, sigs)
        return (choice, fleet.router.last_costs,
                warm.predicted_cached_tokens(prompt),
                cold.predicted_cached_tokens(prompt))
    want, got = both(route)
    assert got == want
    choice, costs, cached, cold = got
    assert choice == 0 and costs[0] < costs[1] and cached > 0 == cold
    expected = tfleet.make_router("cost", weights["port"][0]) \
        .price_per_token_s * (12 - cached)
    assert math.isclose(costs[0], expected)


def test_prefix_affinity_pins_before_first_insertion(weights):
    def routed(pkg):
        fleet = _fleet(weights, pkg, 2, router="prefix_affinity",
                       num_blocks=32, prefix_cache=True)
        shared = _req(pkg, 0, prompt_len=8).prompt
        for rid in range(4):
            req = PKGS[pkg][0].Request(rid=rid, prompt=shared.copy(),
                                       max_new_tokens=2)
            assert fleet.submit(req, tenant="t0") is None
        return fleet.routed, fleet.routed_replica
    want, got = both(routed)
    assert got == want and got[0] in ([4, 0], [0, 4])


def test_prefix_affinity_separates_tenants(weights):
    def routed(pkg):
        fleet = _fleet(weights, pkg, 2, router="prefix_affinity",
                       num_blocks=32, prefix_cache=True)
        for rid in range(4):
            fleet.submit(_req(pkg, rid, prompt_len=8), tenant=f"t{rid}")
        return fleet.routed_replica
    want, got = both(routed)
    assert got == want and sorted(np.bincount(list(got.values()))) == [2, 2]


# ----------------------------- admission ------------------------------ #
def _admit(pkg, config, script):
    """Run ``(rid, tenant, depth, wave)`` arrivals through a controller:
    the rejections (as dicts, None for an admit) and the counters."""
    fl = PKGS[pkg][1]
    ctl = fl.AdmissionController(fl.AdmissionConfig(**config))
    out = [ctl.admit(_req(pkg, rid), tenant, fleet_queue_depth=depth,
                     wave=wave) for rid, tenant, depth, wave in script]
    return ([None if r is None else dataclasses.asdict(r) for r in out],
            ctl.admitted, ctl.rejected, dict(ctl.rejected_by_reason),
            ctl.rejected_below_cap)


def test_admission_queue_cap_rejects_with_retry_hint():
    script = [(0, "a", 1, 0), (1, "a", 2, 3), (2, "a", 5, 4), (3, "b", 0, 4)]
    want, got = both(lambda pkg: _admit(pkg, {"queue_cap": 2}, script))
    assert got == want
    rejs = got[0]
    assert rejs[1]["reason"] == tfleet.REJECT_QUEUE_FULL
    assert (rejs[1]["retry_after_waves"], rejs[1]["wave"]) == (1, 3)
    assert rejs[2]["retry_after_waves"] == 4, "hint scales with overflow"
    assert got[1:3] == (2, 2) and got[4] == 0


def test_admission_token_bucket_isolates_tenants():
    # burst = 2x rate of 20 tokens/wave; each request costs 8 + 4 = 12
    script = [(0, "hog", 0, 0), (1, "hog", 0, 0), (2, "hog", 0, 0),
              (3, "hog", 0, 0), (4, "quiet", 0, 0), (5, "hog", 0, 1),
              (6, "hog", 0, 2), (7, "hog", 0, 2), (8, "hog", 0, 9)]
    cfg = {"tenant_rate": 20.0, "tenant_burst": 40.0}
    want, got = both(lambda pkg: _admit(pkg, cfg, script))
    assert got == want
    rejs = got[0]
    assert rejs[3]["reason"] == tfleet.REJECT_RATE_LIMITED
    assert rejs[3]["retry_after_waves"] >= 1 and rejs[4] is None


def test_admission_uncapped_admits_everything():
    script = [(rid, "t", rid, rid) for rid in range(32)]
    want, got = both(lambda pkg: _admit(pkg, {}, script))
    assert got == want and got[2] == 0


# ---------------------------- load signals ---------------------------- #
def test_load_signal_tracks_queue_and_inflight(weights):
    def signals(pkg):
        cfg, params = weights[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        srv = PKGS[pkg][0].ContinuousBatchingServer(
            cfg, params, batch_size=1, max_len=32, block_size=4,
            prefill_chunk=4, num_blocks=32, **kw)
        rep = PKGS[pkg][1].Replica(0, srv)
        out = [_decided(rep.load_signal())]
        rep.submit(_req(pkg, 0, prompt_len=8, max_new=4))
        rep.submit(_req(pkg, 1, prompt_len=12, max_new=4))
        out.append(_decided(rep.load_signal()))
        while rep.has_work():
            rep.step()
            out.append(_decided(rep.load_signal()))
        last = rep.load_signal()
        assert last.ttft_ewma_s is not None and last.ttft_ewma_s > 0
        assert last.queue_wait_p50_ms is not None
        return out
    want, got = both(signals)
    assert got == want
    assert got[1]["queue_depth"] + got[1]["active"] == 2
    assert got[2]["inflight_prefill_tokens"] == 4
    assert got[2]["queued_prefill_tokens"] == 12


# ------------------------------- fleet -------------------------------- #
def _serve(weights, pkg, policy, n):
    fleet = _fleet(weights, pkg, n, router=policy, num_blocks=32,
                   prefix_cache=True)
    for rid in range(6):
        assert fleet.submit(_req(pkg, rid, max_new=4),
                            tenant=f"t{rid % 2}") is None
    return fleet.run(), _decided(fleet.snapshot()), fleet.routed_replica


@pytest.mark.parametrize("policy", ROUTER_POLICIES)
def test_fleet_matches_single_server_bitwise(weights, policy):
    """The determinism contract at 1, 2 and 3 replicas, each held to the
    reference's fleet of the same size: the same streams, routing and
    snapshot."""
    runs = {n: _serve(weights, "port", policy, n) for n in (1, 2, 3)}
    assert runs[1][0] == runs[2][0] == runs[3][0]
    assert all(len(v) == 4 for v in runs[3][0].values())
    want = _serve(weights, "jax", policy, 3)
    assert runs[3] == want


def test_fleet_run_trace_respects_arrival_waves(weights):
    def trace(pkg):
        fleet = _fleet(weights, pkg, 2, num_blocks=32)
        arrivals = [(0, "a", _req(pkg, 0, max_new=2)),
                    (4, "b", _req(pkg, 1, max_new=2))]
        results, rejections = fleet.run_trace(arrivals)
        return results, rejections, _decided(fleet.snapshot())
    want, got = both(trace)
    assert got == want
    results, rejections, snap = got
    assert rejections == [] and sorted(results) == [0, 1]
    assert snap["waves"] >= 5, "late arrival must not be served early"
    assert snap["admitted"] == 2 and snap["tokens_out"] == 4


def test_fleet_capped_trace_sheds_only_above_cap(weights):
    def trace(pkg):
        fleet = _fleet(weights, pkg, 2, num_blocks=32,
                       admission=PKGS[pkg][1].AdmissionConfig(queue_cap=2))
        arrivals = [(0, "t", _req(pkg, rid, max_new=2)) for rid in range(8)]
        results, rejections = fleet.run_trace(arrivals)
        return (results, [dataclasses.asdict(r) for r in rejections],
                _decided(fleet.snapshot()))
    want, got = both(trace)
    assert got == want
    results, rejections, snap = got
    assert snap["rejected"] == len(rejections) > 0
    assert snap["rejected_below_cap"] == 0
    assert all(r["reason"] == tfleet.REJECT_QUEUE_FULL
               and r["retry_after_waves"] >= 1 for r in rejections)
    served = set(range(8)) - {r["rid"] for r in rejections}
    assert set(results) == served
    assert all(len(results[rid]) == 2 for rid in served)


def test_fleet_affinity_beats_round_robin_on_cached_fraction(weights):
    tenant_of = [0, 0, 0, 0, 1, 1, 1, 1]

    def serve(pkg, policy):
        shared = [_req(pkg, t, prompt_len=8).prompt for t in range(2)]
        fleet = _fleet(weights, pkg, 2, router=policy, num_blocks=32,
                       prefix_cache=True)
        for rid in range(8):
            t = tenant_of[rid]
            fleet.submit(PKGS[pkg][0].Request(rid=rid,
                                              prompt=shared[t].copy(),
                                              max_new_tokens=2),
                         tenant=f"t{t}")
        results = fleet.run()
        assert all(len(v) == 2 for v in results.values())
        return _decided(fleet.snapshot())

    for policy in ("round_robin", "prefix_affinity"):
        want, got = both(lambda pkg: serve(pkg, policy))
        assert got == want
    rr, aff = serve("port", "round_robin"), serve("port", "prefix_affinity")
    assert aff["cached_token_fraction"] > rr["cached_token_fraction"]
    assert aff["prefill_tokens_computed"] < rr["prefill_tokens_computed"]


def test_fleet_export_matches_the_reference(weights):
    """``export_fleet_stats``: the same gauge names, labels and values
    (a tenant label with a quote and a newline survives exposition)."""
    from repro.obs.registry import MetricsRegistry as JRegistry
    from repro_torch.obs.registry import MetricsRegistry, validate_export

    def export(pkg):
        fleet = _fleet(weights, pkg, 2, num_blocks=32,
                       admission=PKGS[pkg][1].AdmissionConfig(queue_cap=1))
        for rid in range(4):
            fleet.submit(_req(pkg, rid, max_new=2),
                         tenant='quo"ted\ntenant')
        fleet.run()
        reg = JRegistry() if pkg == "jax" else MetricsRegistry()
        PKGS[pkg][1].export_fleet_stats(fleet, reg)
        return reg

    jreg, treg = both(export)
    want, got = jreg.export_json()["gauges"], treg.export_json()["gauges"]
    assert validate_export(treg.export_json()) == []
    assert sorted(got) == sorted(want)
    wall = [k for k in got if any(k.split("{")[0].endswith(w)
                                  for w in WALL)]
    assert wall, "the wall-clock gauges are exported too"
    assert {k: v for k, v in got.items() if k not in wall} == \
        {k: v for k, v in want.items() if k not in wall}
    assert any(k.startswith("fleet_rejected_by_tenant{") for k in got)
    assert any(k.startswith("fleet_routed{replica=") for k in got)
    assert "fleet_rejected_by_tenant" in treg.export_prometheus()


@pytest.mark.parametrize("mode", tfleet.ARRIVAL_MODES)
def test_arrival_waves_match_the_reference(mode):
    for seed in range(6):
        for rate in (0.5, 2.0, 5.0):
            kw = dict(rate=rate)
            if mode != "fixed":
                kw["rng"] = np.random.default_rng(seed)
            want = jfleet.arrival_waves(50, mode, **kw)
            kw.pop("rng", None)
            if mode != "fixed":
                kw["rng"] = np.random.default_rng(seed)
            got = tfleet.arrival_waves(50, mode, **kw)
            assert got == want and len(got) == 50
            assert all(x <= y for x, y in zip(got, got[1:]))
    assert tfleet.arrival_waves(5, "fixed") == [0] * 5
    assert tfleet.ARRIVAL_MODES == jfleet.ARRIVAL_MODES
    with pytest.raises(ValueError):
        tfleet.arrival_waves(5, "poisson")     # rng required
    with pytest.raises(ValueError):
        tfleet.arrival_waves(5, "fractal", rng=np.random.default_rng(0))


def test_replicas_share_one_weight_set(weights):
    fleet = _fleet(weights, "port", 3)
    params = weights["port"][1]
    for rep in fleet.replicas:
        assert rep.server.params is params
    pools = {rep.server.pages["k"].data_ptr() for rep in fleet.replicas}
    assert len(pools) == 3, "each replica has a page pool of its own"


# ------------------------------- the CLI ------------------------------ #
def test_serve_cli_fleet_gives_the_single_server_streams(capsys):
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--requests", "6", "--batch", "2",
            "--prompt-len", "12", "--new-tokens", "3", "--shared-prompts",
            "2"]
    single = serve.main(base)
    fleet = serve.main([*base, "--replicas", "2", "--router",
                        "prefix_affinity"])
    bursty = serve.main([*base, "--replicas", "3", "--arrival", "bursty",
                         "--queue-cap", "8", "--tenant-rate", "64"])
    out = capsys.readouterr().out
    assert fleet == single == bursty
    digests = [line for line in out.splitlines() if "streams digest" in line]
    assert len(digests) == 3 and len(set(digests)) == 1
    assert "[fleet] minicpm-2b on cpu: 2 replicas | router prefix_affinity" \
        in out
    assert "below-cap rejects 0" in out


def test_serve_cli_fleet_under_dp_threads(capsys):
    """``--dp`` with fleet flags stripes every replica over the grid; in
    one process the DP axis is that process alone, and the streams are
    the single server's."""
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--requests", "4", "--batch", "2",
            "--prompt-len", "8", "--new-tokens", "3"]
    single = serve.main(base)
    got = serve.main([*base, "--dp", "--replicas", "2"])
    assert got == single
    assert "2 replicas" in capsys.readouterr().out


def test_fleet_on_a_thread_grid_matches_one_server(weights):
    """Two replicas, each striped over a 2-rank ("data",) thread grid
    (the ``--dp`` fleet), give one server's streams on every rank."""
    from repro_torch.collectives import run_local_grid
    cfg, params = weights["port"]
    single = _serve(weights, "port", "round_robin", 1)[0]

    def rank(grid):
        fleet = tfleet.FleetServer(cfg, params, 2, 2, 32, grid=grid,
                                   device="cpu", block_size=4,
                                   prefill_chunk=8, num_blocks=32)
        for rid in range(6):
            fleet.submit(_req("port", rid, max_new=4), tenant=f"t{rid % 2}")
        return fleet.run()

    outs = run_local_grid(rank, (2,), ("data",), device="cpu")
    assert outs[0] == outs[1] == single
