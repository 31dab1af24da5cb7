"""The program's ranges in a traced window (``perfbench/lib/spans.py``),
on synthetic events: each device operation under the innermost range
that launched it, each idle gap charged to the range of the operation
that ends it, the harness's share, and the division by steps."""

import pytest
from torch.autograd import DeviceType

from perfbench.lib import profile, spans

MS = 1_000_000   # ns
STEP = "repro_torch.train.step"
FWD = "repro_torch.train.forward"
BWD = "repro_torch.train.backward"
ATTN = "repro_torch.attn.backward"
OPT = "repro_torch.optim.update"
J = spans.SEP


def one_step(t0=0):
    """A step of 100 ms at ``t0``: forward, backward holding the
    attention backward (another thread: it starts inside), the update."""
    return [(t0, t0 + 100 * MS, STEP), (t0 + 5 * MS, t0 + 40 * MS, FWD),
            (t0 + 40 * MS, t0 + 80 * MS, BWD),
            (t0 + 50 * MS, t0 + 60 * MS, ATTN),
            (t0 + 80 * MS, t0 + 95 * MS, OPT)]


def table(ranges, ops, window=(0, 300 * MS)):
    return spans.table(spans.Spans(window, sorted(
        ranges, key=lambda r: (r[0], -r[1])), sorted(ops)))


def test_each_operation_counts_under_its_innermost_range_once():
    ops = [(10 * MS, 20 * MS, 6 * MS),       # launched in the forward
           (20 * MS, 30 * MS, 52 * MS),      # in the attention backward
           (30 * MS, 35 * MS, 70 * MS),      # in the backward
           (35 * MS, 45 * MS, 90 * MS),      # in the update
           (45 * MS, 46 * MS, 2 * MS),       # in the step itself
           (150 * MS, 151 * MS, 140 * MS)]   # by the harness
    tab = table(one_step(), ops)
    assert set(tab) == {STEP, J.join((STEP, FWD)), J.join((STEP, BWD)),
                        J.join((STEP, BWD, ATTN)), J.join((STEP, OPT)),
                        spans.HARNESS}
    assert tab[J.join((STEP, BWD, ATTN))]["device_s"] == pytest.approx(.01)
    assert tab[J.join((STEP, OPT))]["device_s"] == pytest.approx(.01)
    assert sum(r["launches"] for r in tab.values()) == len(ops)
    assert sum(r["device_s"] for r in tab.values()) == pytest.approx(
        sum(e - s for s, e, _ in ops) * 1e-9)
    # a range's total is the sum over the paths through it
    assert spans.per_step_ms(tab, BWD) == pytest.approx(15.0)
    assert spans.cover(tab)[0] == pytest.approx(0.036)


def test_idle_goes_to_the_range_of_the_operation_that_ends_the_gap():
    ops = [(10 * MS, 20 * MS, 6 * MS),
           (27 * MS, 30 * MS, 55 * MS),      # 7 ms gap: attention's
           (30 * MS, 40 * MS, 85 * MS),      # none
           (44 * MS, 50 * MS, 120 * MS)]     # 4 ms gap: the harness's
    tab = table(one_step(), ops, window=(0, 60 * MS))
    assert tab[J.join((STEP, FWD))]["idle_s"] == pytest.approx(0.010)
    assert tab[J.join((STEP, BWD, ATTN))]["idle_s"] == pytest.approx(.007)
    assert tab[J.join((STEP, OPT))]["idle_s"] == 0.0
    # the gap before a harness operation and the window's tail
    assert tab[spans.HARNESS]["idle_s"] == pytest.approx(0.004 + 0.010)
    assert spans.cover(tab)[1] == pytest.approx(0.017)
    assert spans.per_step_ms(tab, STEP, "idle_s") == pytest.approx(17.0)


def test_per_step_means_over_the_steps_in_the_window():
    ranges = one_step(0) + one_step(100 * MS) + one_step(200 * MS)
    ops = [(t + 10 * MS, t + 14 * MS, t + 55 * MS)
           for t in (0, 100 * MS, 200 * MS)]
    tab = table(ranges, ops, window=(0, 300 * MS))
    assert spans.steps(tab) == 3
    assert tab[J.join((STEP, BWD, ATTN))]["calls"] == 3
    r = spans.readings(tab)
    assert r["attn_bwd_ms.train"] == pytest.approx(4.0)
    assert r["optimizer_ms.train"] == 0.0        # nothing ran there
    # a step that starts before the window is not one of its steps
    tab = table(ranges, ops, window=(50 * MS, 300 * MS))
    assert spans.steps(tab) == 2
    assert spans.per_step_ms(tab, ATTN) == pytest.approx(6.0)


def test_no_ranges_reads_nothing():
    tab = table([], [(0, MS, 5), (2 * MS, 3 * MS, 6)], window=(0, 5 * MS))
    assert set(tab) == {spans.HARNESS}
    assert spans.readings(tab) == {"attn_bwd_ms.train": None,
                                   "optimizer_ms.train": None,
                                   "step_idle_ms.train": None}


class Ev:
    """A stand-in for the profiler's ``_KinetoEvent``."""

    def __init__(self, name, s, e, cuda=False, corr=0, user=False,
                 linked=0):
        self._v = (name, s, e, cuda, corr, user, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def test_collect_follows_correlation_ids_to_the_launches():
    events = [Ev(profile.WINDOW, MS, 200 * MS),
              *(Ev(n, s, e) for s, e, n in one_step(5 * MS)),
              Ev("aten::mm", 56 * MS, 58 * MS, corr=7),
              Ev("cudaLaunchKernel", 57 * MS, 57 * MS + 5000, corr=7),
              Ev("cuLaunchKernel", 90 * MS, 90 * MS + 5000, corr=8),
              Ev("gemm", 60 * MS, 70 * MS, cuda=True, corr=7),
              Ev("adam", 95 * MS, 99 * MS, cuda=True, corr=8),
              Ev("lost", 99 * MS, 100 * MS, cuda=True, corr=9),
              # no launch call in the trace: the linked host operation
              Ev("aten::add_", 91 * MS, 92 * MS, corr=40),
              Ev("linked", 100 * MS, 101 * MS, cuda=True, corr=41,
                 linked=40),
              Ev(ATTN, 60 * MS, 70 * MS, cuda=True, user=True),
              Ev("perfbench.train_step", 0, 1, cuda=True, user=True),
              Ev("early", 0, 2 * MS, cuda=True, corr=10),
              Ev("cudaMemcpyAsync", MS, MS + 100, corr=10)]
    sp = spans.collect(events)
    assert sp.window == (MS, 200 * MS)
    assert [r[2] for r in sp.ranges] == [STEP, FWD, BWD, ATTN, OPT]
    # clipped to the window; "lost" has no launch in the trace
    assert sp.ops == [(MS, 2 * MS, MS), (60 * MS, 70 * MS, 57 * MS),
                      (95 * MS, 99 * MS, 90 * MS), (99 * MS, 100 * MS, -1),
                      (100 * MS, 101 * MS, 91 * MS)]
    tab = spans.table(sp)
    assert tab[J.join((STEP, BWD, ATTN))]["launches"] == 1
    assert tab[J.join((STEP, OPT))]["device_s"] == pytest.approx(0.005)
    assert tab[spans.NO_LAUNCH]["launches"] == 1
    assert tab[spans.HARNESS]["launches"] == 1
    # the device operations and their busy time are the trace's own
    trace = profile.reduce_events(events)
    assert trace.busy_s() == pytest.approx(
        sum(r["device_s"] for r in tab.values()))
    with pytest.raises(RuntimeError):
        spans.collect(events[1:])
