"""The dry-run (``repro_torch.launch.dryrun``): one rank's sharded step on
meta tensors, per (arch x shape x grid) cell.

* the debug grids (2, 4) and (2, 2, 2) on the reduced five families, as
  the reference's ``tests/test_dryrun_small.py`` (its multipod cell is
  no anchor: it fails under JAX 0.9, ROADMAP C2);
* a cell's per-rank parameter and optimizer bytes equal
  ``rank_state_bytes``;
* the collectives counted on the meta step (calls and bytes, by op and
  by axis) equal those of the same step on 8 CPU rank threads, the same
  counter around ``LocalComm``;
* FLOPs at 3 layer units equal the extrapolation from 1 and 2, and the
  peak at 4 units of a step whose largest statement changes with the
  depth equals the extrapolation of each statement's peak;
* every production ``ok`` cell does at least half the model FLOPs (the
  reference's ``test_dryrun_artifacts.py``); every other cell is
  ``skipped`` as the reference skips it; the cells whose heads the model
  axis of 16 does not divide (refused until ROADMAP C33 closed) are
  ``ok`` with their heads padded, a rank's bytes those of
  ``rank_state_bytes`` with the data cut;
* the records' keys are the reference's, and ``--scan`` is refused;
* the counting comm, the kernels' meta bodies and the memory meter.
"""

import ast
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.collectives import run_local, run_local_grid
from repro_torch.collectives.comm import CountingComm, CountingGridComm
from repro_torch.configs import SHAPES, all_configs, cell_is_runnable
from repro_torch.configs import get_config
from repro_torch.configs.base import (ShapeSpec, layer_units,
                                      with_layer_units)
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ss
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs
from repro_torch.launch.mesh import debug_grid, production_grid
from repro_torch.models import init_params
from repro_torch.models.layers import ambient_grid
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import rules
from repro_torch.train.state import init_train_state, rank_state_bytes
from repro_torch.train.step import GradSyncConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_map
from torch_util import record_engines

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("yi-34b", "olmoe-1b-7b", "falcon-mamba-7b", "recurrentgemma-9b",
            "whisper-medium")
DEBUG_SHAPE = dataclasses.replace(SHAPES["train_4k"], seq_len=256,
                                  global_batch=4)
#: the archs whose heads the production model axis of 16 does not divide
#: (56 heads and minicpm-2b's 36: padded, ROADMAP C33)
C33 = ("arctic-480b", "llava-next-34b", "minicpm-2b", "yi-34b")


def _reduced(monkeypatch):
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config", lambda a: real(a).reduced())


@pytest.fixture(autouse=True)
def _private_dirs(tmp_path, monkeypatch):
    """Artifacts and engine decisions in the test's own directories;
    every engine made here flushed before they are unset."""
    monkeypatch.setenv("REPRO_TORCH_DRYRUN_DIR", str(tmp_path / "dryrun"))
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path / "cache"))
    made = record_engines(monkeypatch)
    yield
    for engine in made:
        engine.flush()


# ------------------------------ debug grids ------------------------------ #
@pytest.mark.parametrize("mesh", ["debug", "debug-multipod"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_debug_grid_cells(arch, mesh, monkeypatch):
    _reduced(monkeypatch)
    rec = dryrun.run_cell(arch, DEBUG_SHAPE, mesh)
    assert rec["status"] == "ok", rec
    assert rec["n_devices"] == 8
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["collective_bytes_per_device"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_size_in_bytes"] < mem["peak_memory_in_bytes"]
    assert mem["peak_memory_in_bytes"] == pytest.approx(
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"])
    assert rec["fits"] and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    axes = set(rec["collectives_by_axis_u2"])
    assert "model" in axes
    assert ("pod,data" if mesh == "debug-multipod" else "data") in axes
    with open(rec["artifact"]) as f:
        assert json.load(f)["status"] == "ok"


def _state_bytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@pytest.mark.parametrize("arch", FAMILIES)
def test_rank_bytes_equal_rank_state_bytes(arch):
    for cfg, grid in ((get_config(arch).reduced(), debug_grid()),
                      (get_config(arch), production_grid())):
        sizes = dict(zip(grid[1], grid[0]))
        m = sizes["model"]
        for fsdp in (False, True):
            step = dryrun.RankStep(SHAPES["train_4k"], grid, fsdp=fsdp,
                                   remat=True, microbatches=1)
            _, (state, _), _ = step.build(cfg, use_kernel=True)
            want = rank_state_bytes(cfg, m, n=sizes["data"] if fsdp else 1)
            assert _state_bytes(state.params) == want["params"]
            assert (_state_bytes(state.opt.mu) + _state_bytes(state.opt.nu)
                    == want["opt"])
            # each shard a storage of its own: a rank holds its block only
            for leaf in tree_leaves(state.params):
                assert leaf.untyped_storage().nbytes() == (
                    leaf.numel() * leaf.element_size())


# -------------------- collectives: meta vs 8 CPU ranks -------------------- #
def _real_counts(cfg, grid, mode):
    shape, names = grid
    whole = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DEBUG_SHAPE.global_batch,
                            DEBUG_SHAPE.seq_len)).astype(np.int32))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}

    def fn(g):
        cg = CountingGridComm.around(g)
        policy = rules.for_grid(cg)
        # "fsdp": the reference's for_mesh(fsdp=True), the tree cut over
        # "data" too, its whole leaves synced by the bucketed AllReduce
        params = tree_map(lambda t: t.clone(), rules.shard_params(
            whole, cfg, cg, data_cut=mode == "fsdp"))
        gs = GradSyncConfig(grid=cg, axes=rules.grad_sync_axes_for_grid(cg),
                            mode="allreduce")
        step = make_train_step(cfg, AdamWConfig(), grad_sync=gs)
        rows = specs.rank_rows(policy, DEBUG_SHAPE.global_batch)
        first = cg.axes_index(policy.data_axes) * rows
        mine = {k: v[first:first + rows] for k, v in batch.items()}
        with ambient_grid(cg):
            step(init_train_state(params), mine)
        return cg.counter.ops(), cg.counter.by_axis

    return run_local_grid(fn, shape, names, "cpu", timeout=120)


@pytest.mark.parametrize("mode", ["allreduce", "fsdp"])
@pytest.mark.parametrize("arch", ["yi-34b", "olmoe-1b-7b"])
def test_meta_collectives_equal_a_real_run_on_8_cpu_ranks(arch, mode):
    cfg = get_config(arch).reduced()
    grid = debug_grid()
    real = _real_counts(cfg, grid, mode)
    step = dryrun.RankStep(DEBUG_SHAPE, grid, fsdp=mode == "fsdp",
                           remat=True, microbatches=1)
    run, _, counting = step.build(cfg, use_kernel=True)
    run()
    assert counting.counter.ops() == real[0][0]
    assert counting.counter.by_axis == real[0][1]
    assert rl.collective_total(counting.counter.ops()) > 0
    for ops_r, _ in real:      # every rank's calls are rank 0's
        assert {k: v["count"] for k, v in ops_r.items()} == {
            k: v["count"] for k, v in real[0][0].items()}


# ------------------------------ extrapolation ----------------------------- #
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_at_three_units_equal_the_extrapolation(arch):
    cfg = get_config(arch).reduced()
    step = dryrun.RankStep(DEBUG_SHAPE, debug_grid(), fsdp=True,
                           remat=True, microbatches=1)
    f1, f2, f3 = (dryrun.flop_pass(step, with_layer_units(cfg, u))
                  for u in (1, 2, 3))
    assert f1 < f2 < f3
    assert f3 == f2 + (f2 - f1)


@pytest.mark.parametrize("fsdp", [False, True],
                         ids=["whole-over-data", "data-cut"])
def test_peak_at_four_units_equals_the_extrapolation(fsdp):
    # yi-34b at full width with 4 layers on a (data 2, model 2) grid:
    # whole over "data", the step's largest statement at 1 and 2 units is
    # AdamW's update (the widest leaf's float32 temporaries) and from 3
    # units on the bucketed AllReduce (the flat float32 copy beside the
    # gradients), so the max of the two depths extrapolates short of the
    # peak; each statement extrapolated on its own gives the meter's peak
    # at 4 units exactly
    arch, grid = "yi-34b", ((2, 2), ("data", "model"))
    cfg = with_layer_units(get_config(arch), 4)
    shape = ShapeSpec("4x2048", 2048, 4, "train")
    rec = dryrun.run_cell(arch, shape, "debug", fsdp=fsdp, save=False,
                          grid=grid, levers={"num_layers": cfg.num_layers})
    full = dryrun.card_pass(dryrun.RankStep(shape, grid, fsdp, True, 1),
                            cfg, True)
    assert rec["memory"]["peak_memory_in_bytes"] == full["peak"]


def _ok_cells():
    out = []
    for arch in sorted(all_configs()):
        for shape in SHAPES:
            if cell_is_runnable(get_config(arch), SHAPES[shape])[0]:
                out.append((arch, shape))
    return out


def test_twenty_ok_cells():
    """Twenty until the padded heads; thirty-two with them."""
    assert len(_ok_cells()) == 32


@pytest.mark.parametrize("arch,shape", _ok_cells())
def test_ok_cell_does_at_least_half_the_model_flops(arch, shape):
    """The extrapolated FLOPs of every rank, against 6 N D (2 N D for
    inference): the reference's artifact check."""
    cfg, sh = get_config(arch), SHAPES[shape]
    grid = production_grid()
    step = dryrun.RankStep(sh, grid, fsdp=True, remat=True,
                           microbatches=1)
    units = layer_units(cfg)
    f1, f2 = (dryrun.flop_pass(step, with_layer_units(cfg, u))
              for u in (1, 2))
    flops = f2 + (units - 2) * (f2 - f1)
    terms = rl.roofline_terms(flops, 1.0, 0.0, 256, rl.model_flops(cfg, sh))
    assert terms.hlo_flops_global >= 0.5 * terms.model_flops_global


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_skipped_and_refused_cells(mesh):
    """No cell is refused: the ones the model axis of 16 refused before
    its heads were padded are ``ok`` (``train_4k`` here, the other shapes
    in :func:`test_ok_cell_does_at_least_half_the_model_flops`), a rank's
    state that of ``rank_state_bytes`` with the data cut."""
    grid = dryrun.MESHES[mesh]()
    sizes = dict(zip(grid[1], grid[0]))
    for arch in sorted(all_configs()):
        for shape in SHAPES:
            runnable = cell_is_runnable(get_config(arch), SHAPES[shape])[0]
            if not runnable:
                rec = dryrun.run_cell(arch, shape, mesh, save=False)
                assert rec["status"] == "skipped" and shape == "long_500k"
            elif arch in C33 and shape == "train_4k":
                rec = dryrun.run_cell(arch, shape, mesh, save=False)
                assert rec["status"] == "ok", rec
                pad = rec["padding"]
                assert pad["padded_heads"] != pad["heads"]
                assert 0 < pad["pad_flops_share"] < 0.5
                cfg = get_config(arch)
                step = dryrun.RankStep(SHAPES[shape], grid, fsdp=True,
                                       remat=True, microbatches=1)
                _, (state, _), _ = step.build(cfg, use_kernel=True)
                want = rank_state_bytes(cfg, sizes["model"],
                                        n=sizes["data"])
                assert _state_bytes(state.params) == want["params"]
                assert _state_bytes(state.opt.mu) + _state_bytes(
                    state.opt.nu) == want["opt"]
                assert rec["memory"]["argument_size_in_bytes"] >= (
                    want["params"] + want["opt"])


# ------------------------------ the records ------------------------------ #
def _reference_record_keys():
    """Every key the reference's ``run_cell`` / ``_finish`` writes into
    a record (read from its source: importing it would set up 512
    virtual devices)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.value,
                                                           ast.Name)
                and node.value.id == "record"
                and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "arch"
                for k in node.keys):
            keys.update(k.value for k in node.keys)
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "update"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "record"):
            keys.update(k.value for k in node.args[0].keys)
    return keys


def test_records_keep_the_reference_keys():
    ref = _reference_record_keys()
    assert {"status", "n_devices", "memory", "cost", "roofline",
            "collective_bytes_per_device", "collectives_u2",
            "measure_points"} <= ref
    ok = dryrun.run_cell("mistral-nemo-12b", "train_4k", "pod")
    assert ok["status"] == "ok"
    port_only = {"grid", "route", "fits", "card_bytes",
                 "collectives_by_axis_u2", "roofline_h100", "padding"}
    # "reason" is a skipped cell's, "error" a failed one's,
    # "memory_analysis_error" an XLA error's
    assert set(ok) == (ref - {"reason", "error", "memory_analysis_error"}
                       ) | port_only
    assert ok["cost_scan_counted_once"] is None and ok["hlo_bytes"] is None
    assert set(ok["memory"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes", "peak_memory_in_bytes"}
    assert ok["roofline"]["priced_for"] == "TPU v5e (C8)"
    h = ok["roofline_h100"]
    assert h["bound_s"] == max(h["compute_s"], h["memory_s"])
    assert h["compute_s"] == ok["cost"]["flops"] / 989e12
    # heads neither cut nor padded at 16 (12 over 3 kv heads)
    refused = dryrun.run_cell("yi-34b", "train_4k", "pod",
                              levers={"num_heads": 12, "num_kv_heads": 3})
    skipped = dryrun.run_cell("yi-34b", "long_500k", "pod")
    assert refused["status"] == "refused"
    assert "cannot cut 3 kv heads" in refused["reason"]
    assert set(refused) == set(skipped) == {
        "arch", "shape", "mesh", "microbatches", "fsdp", "remat", "tag",
        "notes", "status", "reason", "artifact"}
    for rec in (ok, refused, skipped):
        with open(rec["artifact"]) as f:
            assert json.load(f)["status"] == rec["status"]
        assert Path(rec["artifact"]).name == (
            f"{rec['arch']}__{rec['shape']}__pod.json")


def test_cli_writes_a_cell_and_refuses_scan(capsys):
    dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "ok: peak" in out and "'ok': 1" in out
    path = Path(dryrun.art_dir()) / "phi3-mini-3.8b__decode_32k__pod.json"
    assert json.loads(path.read_text())["status"] == "ok"
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--scan", "--arch", "yi-34b"])
    assert exc.value.code == 2
    assert "--scan" in capsys.readouterr().err


# ------------------------- the pieces underneath ------------------------- #
@pytest.mark.parametrize("native", ["psum", "psum_scatter", "all_gather",
                                    "all_to_all", "ppermute"])
def test_counting_comm_returns_local_comm_shapes(native):
    x = torch.arange(24, dtype=torch.bfloat16).reshape(8, 3)
    extra = ([(0, 1), (1, 2), (2, 3), (3, 0)],) if native == "ppermute" \
        else ()
    real = run_local(lambda c: getattr(c, native)(x, *extra), 4, "cpu")
    counter = CountingGridComm((4,), ("data",)).counter
    comm = CountingComm(counter, 0, 4, torch.device("meta"), "data")
    got = getattr(comm, native)(x.to("meta"), *extra)
    assert got.is_meta and got.shape == real[0].shape
    assert got.dtype == real[0].dtype
    op = {"psum": "all-reduce", "psum_scatter": "reduce-scatter",
          "all_gather": "all-gather", "all_to_all": "all-to-all",
          "ppermute": "collective-permute"}[native]
    assert counter.by_axis == {"data": {op: {
        "bytes": float(got.numel() * 2), "count": 1}}}
    assert counter.ops()[op]["count"] == 1
    with pytest.raises(ValueError):
        comm.psum(x)                     # a CPU tensor on a meta comm


def test_kernel_meta_bodies_launch_nothing():
    ops.reset_launch_counts()
    meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt,
                                                    device="meta")
    q = meta(2, 4, 128, 64, dt=torch.bfloat16).requires_grad_()
    k = meta(2, 2, 128, 64, dt=torch.bfloat16)
    o = ops.flash_attention(q, k, k)
    assert o.shape == q.shape and o.is_meta
    assert [tuple(t.shape) for t in o.grad_fn.saved_tensors] == [
        (2, 4, 128, 64), (2, 2, 128, 64), (2, 2, 128, 64), (2, 4, 128, 64),
        (2, 4, 128)]
    assert isinstance(o.grad_fn, FlashAttentionFn._backward_cls)
    (dq,) = torch.autograd.grad(o.float().sum(), q)
    assert dq.shape == q.shape
    x = meta(2, 100, 48).requires_grad_()
    b, a, h0 = meta(2, 100, 16), meta(48, 16), meta(2, 48, 16)
    y, h = ops.selective_scan(x, x, b, b, a, h0, trainable=True)
    hck = y.grad_fn.saved_tensors[-1]
    assert hck.shape == (2, -(-100 // ss.CKPT_CHUNK), 48, 16)
    assert torch.autograd.grad(y.sum(), x)[0].shape == x.shape
    assert ops.selective_scan(x.detach(), x.detach(), b, b, a,
                              h0)[1].shape == h0.shape
    w = meta(48, 32, dt=torch.bfloat16)
    assert ops.matmul_tiled(meta(8, 48, dt=torch.bfloat16),
                            w).shape == (8, 32)
    assert ops.paged_attention(
        meta(2, 8, 64), meta(10, 16, 2, 64), meta(10, 16, 2, 64),
        meta(2, 4, dt=torch.int32), meta(2, dt=torch.int32)).shape == (2, 8,
                                                                     64)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_scan_meta_shapes_are_the_kernel_source_s():
    src = (ROOT / "src/repro_torch/kernels/csrc/selective_scan.cu"
           ).read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       src).group(1))
    assert ss.CKPT_CHUNK == const("kChunk")
    assert ss.BWD_CHANNELS == const("kBwdChannels")


def test_meter_counts_live_rounded_storages():
    x = torch.empty(1000, device="meta")            # 4000 -> 4096 bytes
    meter = dryrun._Meter((x,))
    assert meter.argument_bytes == 4096
    with meter:
        y = x * 2                                   # + 4096 live
        z = y[:10]                                  # a view: nothing
        del y
        w = torch.ones(3, device="meta")            # + 512; y still held
        del z                                       # y's storage freed
        s = x.sum()
    assert meter.peak == 4096 + 4096 + 512
    assert meter.live == 4096 + 512 + 512
    assert meter.outputs((x, w, s)) == (1024, 4096)
    assert meter.accessed == 4000 * 2 + 12 + 4000 + 4


def _gather_ce(x, w, idx):
    """A vocab-parallel cross entropy's pieces: its backward sums two
    gradients of the logits and scatters the gather's."""
    logits = (x @ w).float()
    peak = logits.detach().amax(-1)
    gold = logits.gather(-1, idx[..., None])[..., 0]
    lse = torch.log(torch.exp(logits - peak[..., None]).sum(-1)) + peak
    return (lse - gold).mean()


def _lookup(x, w, idx):
    """An embedding lookup: its backward puts the rows' gradients into
    the zeros it makes."""
    return (w.T[idx % w.shape[1]] * x).sum()


def _eager_cpu_peak(fn, shapes):
    """Peak bytes the CPU allocator holds above the arguments while
    ``fn``'s forward and backward run eagerly (no dispatch mode), from the
    profiler's allocation events."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    x, w = (torch.randn(s, generator=gen, requires_grad=True)
            for s in shapes[:2])
    idx = torch.randint(0, shapes[1][1], shapes[2], generator=gen)
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        torch.autograd.grad(fn(x, w, idx), (x, w))
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("fn", [_gather_ce, _lookup],
                         ids=["gather_ce", "lookup"])
def test_meter_peak_equals_eager_allocations(fn):
    """Under its dispatch mode autograd takes out-of-place branches (the
    engine's gradient sum, the gather and index backward's scatters);
    the meter counts them in place, as eager execution without a mode
    allocates: the peak equals the CPU allocator's within the 512-byte
    rounding of the few live tensors."""
    shapes = ((2, 64, 32), (32, 1000), (2, 64))
    want = _eager_cpu_peak(fn, shapes)
    x, w = (torch.empty(s, device="meta", requires_grad=True)
            for s in shapes[:2])
    idx = torch.zeros(shapes[2], dtype=torch.int64, device="meta")
    meter = dryrun._Meter((x, w, idx))
    with meter:
        torch.autograd.grad(fn(x, w, idx), (x, w))
    got = meter.peak - meter.argument_bytes
    assert want >= 128_000                    # a [32, 1000] float32 leaf
    assert 0 <= got - want <= 16 * dryrun.ALLOC_BLOCK, (got, want)
