"""The train step's regions (``obs.trace.region``) on the CPU.

* Under ``torch.profiler`` a dense train step opens ``repro_torch.
  train.step`` once a step, and inside it ``train.forward``,
  ``train.backward`` and ``optim.update`` once each, in that order.
* ``FlashAttentionFn.backward`` is one ``repro_torch.attn.backward``
  range and returns the plain backward's gradients.
* With the profiler and the tracer off, no ``record_function`` is
  entered at all.
* With the tracer on, step spans (``CAT_STEP``) carry the optimizer
  count as ``step``, a DP step's collective spans keep their own tree
  (a parentless collective span is still one call), and
  ``validate_spans`` passes on the mixed trace.
* The engine's collectives and a plan's phases are ``repro_torch.
  collective.<op>[.<phase>]`` profiler ranges with the tracer off.
"""

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from repro_torch.collectives import run_local, run_local_grid
from repro_torch.collectives.engine import CollectiveEngine
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)
from repro_torch.models import init_params
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import init_train_state
from repro_torch.train.step import GradSyncConfig, make_train_step

CFG = ArchConfig(name="tiny", family="dense", num_layers=2, d_model=32,
                 num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                 dtype="float32")
OPT = AdamWConfig(warmup_steps=1, total_steps=10)
STEP_RANGES = ("repro_torch.train.step", "repro_torch.train.forward",
               "repro_torch.train.backward", "repro_torch.optim.update")


@pytest.fixture(autouse=True)
def _private_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))


@pytest.fixture
def tracer():
    tr = obs_trace.Tracer(enabled=True)
    prev = obs_trace.set_tracer(tr)
    yield tr
    obs_trace.set_tracer(prev)


def _batch(rows=4, seq=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CFG.vocab_size, (rows, seq + 1), generator=g)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def _ranges(prof):
    """The profiler's ``repro_torch.*`` ranges as (start, end, name),
    in start order."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.name.startswith("repro_torch."))


def _all_threads():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def test_train_step_regions_nest_once_a_step():
    step = make_train_step(CFG, OPT)
    state = init_train_state(init_params(CFG, 0, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            state, _ = step(state, _batch(seed=i))
    ranges = _ranges(prof)
    assert sorted({n for _, _, n in ranges}) == sorted(STEP_RANGES)
    steps = [r for r in ranges if r[2] == STEP_RANGES[0]]
    assert len(steps) == 2
    for s0, e0, _ in steps:
        inside = [n for s, e, n in ranges if s0 < s and e <= e0]
        assert inside == list(STEP_RANGES[1:])
    assert len(ranges) == 2 * len(STEP_RANGES)


def test_flash_backward_is_one_region_with_the_same_gradients():
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(1, 2, 64, 16, generator=g)
                   for _ in range(4))
    o, lse = flash_attention_ref(q, k, v, causal=True)

    class Ctx:
        saved_tensors = (q, k, v, o, lse)
        causal, window = True, None

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = FlashAttentionFn.backward(Ctx(), do)
    assert [n for _, _, n in _ranges(prof)] == ["repro_torch.attn.backward"]
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, True, None)
    assert got[3:] == (None, None)
    for a, b in zip(got[:3], want):
        assert torch.equal(a, b)


def test_no_record_function_with_profiler_and_tracer_off(monkeypatch):
    def refuse(name, *args, **kw):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not obs_trace.get_tracer().enabled
    assert obs_trace.region("repro_torch.x") is obs_trace.NULL_SPAN
    step = make_train_step(CFG, OPT)
    state = init_train_state(init_params(CFG, 0, "cpu"))
    state, metrics = step(state, _batch())
    assert torch.isfinite(metrics["loss"])
    q = torch.randn(1, 2, 64, 16)
    o, lse = flash_attention_ref(q, q, q)

    class Ctx:
        saved_tensors = (q, q, q, o, lse)
        causal, window = True, None

    FlashAttentionFn.backward(Ctx(), torch.ones_like(q))
    eng = CollectiveEngine(persist=False, device="cpu")
    xs = [torch.full((64,), float(r)) for r in range(2)]
    out = run_local(lambda c: eng.allreduce(xs[c.rank], c), 2,
                    device="cpu")
    assert all(torch.equal(x, torch.full((64,), 1.0)) for x in out)


def test_step_spans_carry_the_count_beside_collective_spans(tracer):
    def fn(grid):
        gs = GradSyncConfig(grid=grid, axes=("data",))
        step = make_train_step(CFG, OPT, grad_sync=gs)
        state = init_train_state(init_params(CFG, 0, "cpu"))
        for i in range(2):
            state, _ = step(state, _batch(rows=2, seed=2 * i + grid.rank))

    run_local_grid(fn, (2,), ("data",), "cpu", timeout=120)
    spans = tracer.spans
    steps = [s for s in spans if s.cat == obs_trace.CAT_STEP]
    names = {s.name for s in steps}
    assert names == set(STEP_RANGES) | {"repro_torch.train.grad_sync"}
    tops = [s for s in steps if s.name == STEP_RANGES[0]]
    assert sorted(s.args["step"] for s in tops) == [1, 1, 2, 2]
    by_id = {s.span_id: s for s in spans}
    for s in steps:
        assert s.args["step"] in (1, 2)
        parent = by_id.get(s.parent_id)
        assert (parent is None) == (s.name == STEP_RANGES[0])
        assert parent is None or parent.cat == obs_trace.CAT_STEP
    coll = [s for s in spans if s.cat == obs_trace.CAT_COLLECTIVE]
    assert coll and all(by_id.get(s.parent_id) is None
                        or by_id[s.parent_id].cat != obs_trace.CAT_STEP
                        for s in coll)
    assert all("measured_s" in s.args for s in coll)
    assert not any("step" in s.args for s in coll)
    assert obs_trace.validate_spans(spans) == []


def test_collective_and_phase_ranges_with_the_tracer_off():
    eng = CollectiveEngine(persist=False, device="cpu")
    xs = [torch.full((4096,), float(r)) for r in range(4)]
    with _all_threads() as prof:
        run_local(lambda c: eng.allreduce(xs[c.rank], c), 4, device="cpu")
        run_local_grid(lambda g: eng.allreduce_multi(
            xs[g.rank], g, ("pod", "data"), "hierarchical"), (2, 2),
            ("pod", "data"), device="cpu")
    assert not obs_trace.get_tracer().enabled
    names = [n for _, _, n in _ranges(prof)]
    assert names.count("repro_torch.collective.allreduce") >= 8
    phases = [n for n in names
              if n.startswith("repro_torch.collective.allreduce.")]
    assert phases and all("@" in n and ":" not in n for n in phases)
