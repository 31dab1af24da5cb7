"""The reduction from traces and counts to metrics, on synthetic
traces: the idle union, the roofline, MFU, and the comparison."""

import math

import pytest

from perfbench.lib import checks, manifest, peaks, profile

MS = 1_000_000   # ns


def trace(device, host=(), window=(0, 100 * MS)):
    dev = sorted((max(s, window[0]), min(e, window[1]), n)
                 for s, e, n in device)
    return profile.Trace(window, dev, sorted(host),
                         [h for h in host if h[2].startswith("perfbench.")])


def test_busy_is_the_union_of_overlapping_kernels():
    t = trace([(0, 10 * MS, "a"), (5 * MS, 20 * MS, "b"),
               (50 * MS, 60 * MS, "a")])
    assert t.busy_s() == pytest.approx(0.030)
    assert t.idle_gaps() == [(20 * MS, 50 * MS), (60 * MS, 100 * MS)]
    s = t.summary()
    assert s["kernels"]["a"] == [pytest.approx(0.020), 2]
    assert profile.idle_share(s) == pytest.approx(70.0)
    assert manifest.load_reader("device_idle_share.train")(
        {"trace": s}) == pytest.approx(70.0)


def test_gaps_are_named_by_the_innermost_host_range():
    host = [(0, 100 * MS, "perfbench.step_once"),
            (25 * MS, 45 * MS, "aten::copy_")]
    t = trace([(0, 20 * MS, "k"), (50 * MS, 100 * MS, "k")], host)
    names = dict(t.breakdown()["idle_gaps"])
    assert names == {"aten::copy_": pytest.approx(0.030)}


def test_kernel_time_matches_by_name():
    s = trace([(0, 4 * MS, "void flash_fwd_wgmma<64>(...)"),
               (10 * MS, 12 * MS, "paged_mma"),
               (20 * MS, 21 * MS, "gemm")]).summary()
    assert profile.kernel_time(s, lambda n: "flash_fwd" in n) == (
        pytest.approx(0.004), 1)


ARCH = manifest.load_json(manifest.PERFBENCH / "configs"
                          / "minicpm-2b.json")["arch"]
TRAIN = manifest.load_json(manifest.PERFBENCH / "traffic" / "train-4k.json")


def read(name, ctx):
    return manifest.load_reader(name)(ctx)


def test_flash_roofline_is_bound_times_launches_over_time():
    bound = peaks.flash_bound_s(2, 36, 36, 4096, 64)
    assert bound * 1e3 == pytest.approx(0.1564, abs=1e-4)   # chip_smoke
    s = {"kernels": {"flash_fwd_wgmma<64>": [4 * 4 * bound, 4]}}
    ctx = {"arch": ARCH, "traffic": TRAIN, "trace": s}
    assert read("flash_fwd_roofline.train", ctx) == pytest.approx(25.0)
    s0 = {"kernels": {"flash_fwd_renamed": [1.0, 0]}}
    assert read("flash_fwd_roofline.train", dict(ctx, trace=s0)) is None


def test_train_mfu():
    flops = peaks.train_flops_per_step(ARCH, 2, 4096)
    # 6 per matmul parameter and token, plus the causal attention
    assert flops == pytest.approx(1.525e14, rel=2e-3)
    ctx = {"arch": ARCH, "counts": {"steps": 10, "rows": 2, "seq": 4096},
           "trace": {"window_s": 10.0}}
    want = 100 * 10 * flops / (10.0 * 989e12)
    assert read("mfu.train", ctx) == pytest.approx(want)
    assert read("mfu.train", dict(ctx, counts={"steps": 0})) is None


def test_judge():
    ok, rows = checks.judge({"a": 0.1, "b": 5.0},
                            {"a": {"limit": 0.2}, "b": {"limit": None}})
    assert ok and rows == [("a", 0.1, 0.2), ("b", 5.0, None)]
    assert not checks.judge({"a": 0.3}, {"a": {"limit": 0.2}})[0]
    assert not checks.judge({"a": math.nan}, {"a": {"limit": 0.2}})[0]
    assert not checks.judge({}, {"a": {"limit": 0.2}})[0]


def test_leaf_gap_takes_the_median_leaf_as_the_floor():
    ref = {"big": 10.0, "mid": 1.0, "tiny": 1e-6}
    prog = {"big": 10.1, "mid": 1.0, "tiny": 2e-6}
    gap, leaf = checks.leaf_gap(prog, ref, sorted(ref))
    assert leaf == "big" and gap == pytest.approx(0.01)


def test_still_leaves_leave_the_change_comparison():
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 1.0, "c": 1e-9},
           "change": {"a": 1.0, "b": 1.0, "c": 1e-9}}
    prog = {"loss": [1.0], "grad": dict(ref["grad"]),
            "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    n = checks.train_numbers(prog, ref)
    assert n["change_gap"] == 0.0 and n["detail"]["still_leaves"] == 1
