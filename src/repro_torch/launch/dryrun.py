"""The dry-run: every (arch x shape x grid) cell sized as one rank's
sharded step on meta tensors (the counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step on 512 virtual
devices and reads XLA's memory and cost analyses.  The port builds no
program.  It runs rank 0 of the grid (every rank's shapes are equal) on
meta tensors, so nothing is allocated and no device is needed; it runs
on the host, as the reference's does:

* the state is ``shard_train_state(abstract_train_state(cfg), cfg,
  grid, data_cut=fsdp)``: under ``fsdp`` (the default, the reference's
  ``for_mesh(fsdp=True)``) the tree, its gradients and its moments are
  cut over "data" too (ZeRO-3), for prefill and decode the tree too;
  ``--no-fsdp`` keeps the tree whole over "data".  Heads and a
  vocabulary the model axis does not divide are padded
  (``sharding.rules.padded_heads``, ``padded_vocab``).  The
  batch and the decode cache are a rank's rows (``launch.specs``);
* the step is ``make_train_step(..., grad_sync=GradSyncConfig(grid,
  axes=grad_sync_axes_for_grid(grid), mode="allreduce"))``,
  ``make_prefill_step`` or ``make_decode_step``, under
  ``ambient_grid`` of a ``CountingGridComm``: the collectives on the
  count are the engine's own plans (the data cut's per-layer allgathers
  and reduce-scatters, bucketed AllReduce, TP's two allreduces a block,
  EP's AllToAll), not GSPMD's;
* **memory**: a dispatch mode counts live storage bytes (added when an
  operator returns a new storage, rounded up to the CUDA caching
  allocator's 512-byte blocks; dropped when the storage is freed) on
  the card's route, where each kernel is its shape-only body
  (``kernels.ops``): the outputs and saved tensors the card holds; the
  backward's gradient sums and scatters, which autograd runs out of
  place under a Python mode only, counted in place.  The reference's
  ``memory`` keys: the arguments (state, batch, cache), the outputs not
  among them, the peak, and the temporaries between;
* **cost**: ``bytes accessed`` is the sum of every operator's input and
  output bytes on that route (views and allocations excluded; a kernel
  body counts what the kernel reads and writes): what eager execution
  moves.  FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
  on a second pass over the plain route, where it sees every product (a
  kernel body is one operator it cannot price);
* memory, bytes, FLOPs and collective bytes are measured at 1 and 2
  layer units (``configs.base.layer_units`` / ``with_layer_units``) and
  extrapolated linearly to the full depth, as the reference does; the
  arguments are taken exactly at full depth.

The record keeps the reference's keys.  ``roofline`` is priced by
``launch.roofline`` for a TPU v5e (labelled so: ROADMAP C8);
``roofline_h100`` is the data-sheet bound on one H100, max(FLOPs / 989e12,
bytes / 3.35e12), with no collective term (no NVLink fit ships: C8).
``fits`` holds the peak against one H100 80GB HBM3.  ``padding`` holds
the real and padded vocabulary and the share of the head's FLOPs and
bytes spent on pad ids, and, for an attention config, the real and
padded heads and the share of the attention's FLOPs and bytes a rank
spends on pad heads (the reference's roofline shows GSPMD's padding as
HLO FLOPs over model FLOPs).  ``lower_s`` is
the wall of building the full-depth arguments, ``compile_s`` of the
card-route passes, ``measure_s`` of the FLOP passes; keys without a
counterpart (XLA's scan-once cost, the HLO's size) are null.  A cell
``cell_is_runnable`` rules out is ``skipped``; one whose model axis the
execution layout can neither cut nor pad (``sharding.rules.
exec_layout``) is ``refused``; any other exception is ``failed``.

Usage (no device needed):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch mistral-nemo-12b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod \
        --workers 4
Artifacts: ``var/dryrun_torch/<arch>__<shape>__<mesh>.json``
(``REPRO_TORCH_DRYRUN_DIR`` overrides).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
import weakref
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.collectives.api import set_engine
from repro_torch.collectives.comm import CountingGridComm
from repro_torch.collectives.engine import CollectiveEngine
from repro_torch.configs import (SHAPES, all_configs, cell_is_runnable,
                                 get_config)
from repro_torch.configs.base import (ArchConfig, ShapeSpec, layer_units,
                                      with_layer_units)
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import Grid, debug_grid, production_grid
from repro_torch.models import transformer as tf
from repro_torch.models.layers import ambient_grid
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.sharding import rules
from repro_torch.train.state import (TrainState, abstract_train_state,
                                     shard_train_state)
from repro_torch.train.step import (GradSyncConfig, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.tree import tree_map

_REPO = os.path.join(os.path.dirname(__file__), "..", "..", "..")

#: one H100 80GB HBM3: device memory (``total_memory``, PERF.md section 4)
#: and the SXM data sheet's dense bf16 rate and HBM bandwidth
CARD_BYTES = 85.017e9
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
#: the CUDA caching allocator's block size: every allocation rounds up
ALLOC_BLOCK = 512

#: the grids of ``--mesh``
MESHES: Dict[str, Callable[[], Grid]] = {
    "pod": production_grid,
    "multipod": lambda: production_grid(multi_pod=True),
    "debug": debug_grid,
    "debug-multipod": lambda: debug_grid(multi_pod=True),
}

_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default,
                torch.ops.aten.empty_like.default}


def art_dir() -> str:
    return os.environ.get("REPRO_TORCH_DRYRUN_DIR",
                          os.path.join(_REPO, "var", "dryrun_torch"))


#: the out-of-place scatters of backward formulas under a dispatch mode
#: (``gather_backward``, ``index_backward``, ``index_select_backward``)
_SCATTERS = {torch.ops.aten.scatter_add.default,
             torch.ops.aten.index_put.default,
             torch.ops.aten.index_add.default}


def _backward_node() -> Optional[Tuple[str, int]]:
    """The backward node running now, as (name, sequence number), or
    None: its Python object is made anew on some calls (torch 2.11)."""
    node = torch._C._current_autograd_node()
    return None if node is None else (node.name(), node._sequence_nr())


def _alloc_bytes(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _meta_tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree)
            if torch.is_tensor(t) and t.is_meta]


class _Meter(TorchDispatchMode):
    """Live and peak storage bytes of meta tensors, and bytes accessed,
    over the operators run under it.  The storages of ``args`` are live
    from the start (the step's arguments).  With ``run`` (the code of the
    function that calls the step) the peak is also kept for each
    statement of the step that runs the operator (``phase_peaks``, by
    line): each is linear in the depth, their max is not.

    A Python dispatch mode makes every tensor "subclass-like" to
    PyTorch's C++ autograd, which then takes out-of-place branches the
    card does not: the engine sums two gradients of one tensor into a new
    one (without a mode it adds the second into the first, whose storage
    it holds alone), and the gather and index backward formulas scatter
    into a copy of the zeros they just made.  Those operators
    (:meth:`_in_place`) are counted in place, as the card runs them."""

    def __init__(self, args: Any, run: Any = None):
        super().__init__()
        self.live = 0
        self.accessed = 0
        self._sizes: Dict[int, int] = {}
        #: storage -> the autograd node that made it (None: no node)
        self._made_by: Dict[int, Optional[Tuple[str, int]]] = {}
        self.arguments = set()
        for t in _meta_tensors(args):
            self.arguments.add(self._track(t))
        self.argument_bytes = self.live
        self.peak = self.live
        self._run = run
        self.phase_peaks: Dict[Optional[int], int] = {}

    def _phase(self) -> Optional[int]:
        """The line of the step's statement running now (the frame that
        ``run`` called), or None."""
        f = sys._getframe(2)
        while f.f_back is not None and f.f_back.f_code is not self._run:
            f = f.f_back
        return None if f.f_back is None else f.f_lineno

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key not in self._sizes:
            n = _alloc_bytes(st.nbytes())
            self._sizes[key] = n
            self._made_by[key] = _backward_node()
            self.live += n
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)
        self._made_by.pop(key, None)

    def _in_place(self, func, args, kwargs, out) -> bool:
        """Whether ``func`` runs in place on the card: inside a backward
        node, the engine summing the gradient the node just made
        (``args[1]``) into the one an earlier node left (``args[0]``), or
        a scatter into the zeros the node itself made (``args[0]``)."""
        node = _backward_node()
        if (node is None or torch.is_grad_enabled() or not args
                or not torch.is_tensor(out)):
            return False
        first = args[0]
        if not (torch.is_tensor(first) and first.is_meta
                and first.shape == out.shape and first.dtype == out.dtype
                and first.is_contiguous()):
            return False
        made = self._made_by.get
        by_node = made(id(first.untyped_storage())) == node
        if func in _SCATTERS:
            return by_node
        if func is not torch.ops.aten.add.Tensor or kwargs or \
                len(args) != 2:
            return False
        new = args[1]
        return (not by_node and made(id(first.untyped_storage())) is not None
                and torch.is_tensor(new) and new.is_meta
                and new.shape == out.shape and new.dtype == out.dtype
                and made(id(new.untyped_storage())) == node)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _ALLOCATIONS and not func.is_view:
            self.accessed += sum(t.numel() * t.element_size() for t in
                                 _meta_tensors((args, kwargs, out)))
        for t in _meta_tensors(out):
            self._track(t)
        # an in-place sum holds no new storage: the engine drops the old
        # gradient as soon as this returns
        live = self.live
        if self._in_place(func, args, kwargs, out):
            live -= self._sizes[id(out.untyped_storage())]
        self.peak = max(self.peak, live)
        if self._run is not None:
            line = self._phase()
            self.phase_peaks[line] = max(self.phase_peaks.get(line, 0),
                                         live)
        return out

    def outputs(self, out: Any) -> Tuple[int, int]:
        """(bytes of the storages ``out`` holds that are not arguments,
        bytes of those that are)."""
        fresh = alias = 0
        seen = set()
        for t in _meta_tensors(out):
            key = id(t.untyped_storage())
            if key in seen or key not in self._sizes:
                continue
            seen.add(key)
            if key in self.arguments:
                alias += self._sizes[key]
            else:
                fresh += self._sizes[key]
        return fresh, alias


@dataclasses.dataclass
class RankStep:
    """Rank 0's step of a cell on ``grid`` (shape, axis names), built
    anew for each pass and depth (:meth:`build`)."""
    shape: ShapeSpec
    grid: Grid
    fsdp: bool
    remat: bool
    microbatches: int

    def build(self, cfg: ArchConfig, use_kernel: bool
              ) -> Tuple[Callable[[], Any], Any, CountingGridComm]:
        """(run, arguments, grid): ``run()`` is the rank's step on its
        arguments under its counting grid."""
        grid = CountingGridComm(*self.grid)
        policy = rules.for_grid(grid, fsdp=self.fsdp)
        shape = self.shape
        batch = sp.rank_batch_specs(policy, sp.input_specs(cfg, shape))
        if shape.step == "train":
            state = _own_state(shard_train_state(
                abstract_train_state(cfg), cfg, grid, data_cut=self.fsdp))
            gs = GradSyncConfig(grid=grid,
                                axes=rules.grad_sync_axes_for_grid(grid),
                                mode="allreduce")
            step = make_train_step(cfg, AdamWConfig(), self.microbatches,
                                   remat=self.remat, grad_sync=gs,
                                   use_kernel=use_kernel)
            args: Any = (state, batch)
        else:
            params = _own(rules.shard_params(
                tf.init_params(cfg, device="meta"), cfg, grid,
                data_cut=self.fsdp))
            if shape.step == "prefill":
                step = make_prefill_step(cfg, use_kernel=use_kernel)
                args = (params, batch)
            else:
                step = make_decode_step(cfg)
                args = (params, sp.rank_cache_specs(cfg, shape, policy),
                        batch)

        # the rules' bookkeeping (a whole tree's shapes on the meta
        # device, cached by config) is made here, outside any meter:
        # no device holds it
        rules.tree_cuts(args[0].params if shape.step == "train"
                        else args[0], cfg, grid)

        def run():
            with ambient_grid(grid):
                return step(*args)
        return run, args, grid


def _own(tree: Any) -> Any:
    """Each leaf a meta tensor with a storage of its own: a rank holds
    its shards, not the whole leaves ``shard_params``' views share."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def _own_state(state: TrainState) -> TrainState:
    opt = state.opt
    return TrainState(params=_own(state.params), opt=AdamWState(
        mu=_own(opt.mu), nu=_own(opt.nu), count=opt.count,
        master=None if opt.master is None else _own(opt.master)))


def padding_record(cfg: ArchConfig, shape: ShapeSpec, m: int
                   ) -> Dict[str, Any]:
    """What padding to a model axis of ``m`` costs.  The vocabulary
    (``rules.padded_vocab``): the share of the head's FLOPs (2 D a word a
    token) and of its and the embedding's bytes that the ranks spend on
    pad ids, (Vp - V) / Vp of each.  The heads of an attention config:
    the share of a layer's attention FLOPs (the four projections, 2 D hd
    a head a token each, and the core, 4 hd a head a (query, key) pair:
    half the context causal, all of it in decode) and of its attention
    bytes (the projections' weights, and a decode cell's KV cache) that a
    rank spends on pad heads."""
    v, vp = cfg.vocab_size, rules.padded_vocab(cfg, m)
    rec: Dict[str, Any] = {"model_axis": m, "vocab": v, "padded_vocab": vp,
                           "pad_vocab_flops_share": 1 - v / vp,
                           "pad_vocab_bytes_share": 1 - v / vp}
    if not cfg.num_heads:
        return rec
    h, kv = cfg.num_heads, cfg.num_kv_heads
    hp, kvp = rules.padded_heads(cfg, m)
    d, hd, s = cfg.d_model, cfg.resolved_head_dim, shape.seq_len
    keys = s if shape.step == "decode" else (s + 1) / 2

    def flops(q, k):
        return 2 * d * hd * (2 * q + 2 * k) + 4 * hd * q * keys

    def nbytes(q, k):
        cache = 2 * s * k * hd if shape.step == "decode" else 0
        return d * hd * (2 * q + 2 * k) + cache

    rec.update({"heads": [h, kv], "padded_heads": [hp, kvp],
                "pad_flops_share": 1 - flops(h, kv) / flops(hp, kvp),
                "pad_bytes_share": 1 - nbytes(h, kv) / nbytes(hp, kvp)})
    return rec


def card_pass(cell: RankStep, cfg: ArchConfig, use_kernel: bool
              ) -> Dict[str, Any]:
    """Memory, bytes accessed and collectives of one step on the card's
    route."""
    run, args, grid = cell.build(cfg, use_kernel)
    meter = _Meter(args, run.__code__)
    with meter:
        out = run()
    fresh, alias = meter.outputs(out)
    return {"arguments": meter.argument_bytes, "peak": meter.peak,
            "phase_peaks": meter.phase_peaks,
            "outputs": fresh, "alias": alias, "bytes": meter.accessed,
            "collectives": grid.counter.ops(),
            "collectives_by_axis": grid.counter.by_axis}


def flop_pass(cell: RankStep, cfg: ArchConfig) -> float:
    """FLOPs of one step on the plain route."""
    run, _, _ = cell.build(cfg, use_kernel=False)
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return float(counter.get_total_flops())


def _grid_of(mesh_kind: str, grid: Optional[Grid]) -> Grid:
    if grid is not None:
        return grid
    if mesh_kind not in MESHES:
        raise ValueError(f"unknown mesh {mesh_kind!r}; expected one of "
                         f"{sorted(MESHES)} or a grid=")
    return MESHES[mesh_kind]()


def run_cell(arch: str, shape: Union[str, ShapeSpec], mesh_kind: str = "pod",
             microbatches: int = 1, fsdp: bool = True, remat: bool = True,
             tag: str = "", save: bool = True, extra_notes: str = "",
             levers: Optional[Dict[str, Any]] = None,
             grid: Optional[Grid] = None) -> Dict[str, Any]:
    """One dry-run cell: rank 0's step of ``grid`` (default: the grid
    ``mesh_kind`` names) at ``shape`` (a name of ``SHAPES`` or a
    ``ShapeSpec``), measured at 1 and 2 layer units and extrapolated
    (the module docstring).  ``mesh_kind`` labels the record."""
    cfg = get_config(arch)
    if levers:
        cfg = dataclasses.replace(cfg, **levers)
    if isinstance(shape, str):
        shape = SHAPES[shape]
    grid = _grid_of(mesh_kind, grid)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "microbatches": microbatches, "fsdp": fsdp, "remat": remat,
        "tag": tag, "notes": extra_notes,
    }
    runnable, why = cell_is_runnable(cfg, shape)
    if not runnable:
        record.update({"status": "skipped", "reason": why})
        return _finish(record, save)
    names, sizes = grid[1], grid[0]
    m = dict(zip(names, sizes)).get("model", 1)
    try:
        rules.exec_layout(cfg, m)
    except ValueError as e:
        record.update({"status": "refused", "reason": str(e)})
        return _finish(record, save)
    _use_meta_engine()
    record["n_devices"] = math.prod(sizes)
    record["grid"] = {"shape": list(sizes), "axes": list(names)}
    # the kernel route raises on bf16 probabilities (ROADMAP C11): such a
    # lever is sized on the plain route
    use_kernel = not cfg.attn_probs_bf16
    record["route"] = "kernel" if use_kernel else "plain"
    cell = RankStep(shape, grid, fsdp, remat, microbatches)

    t0 = time.time()
    full_args = _Meter(cell.build(cfg, use_kernel)[1]).argument_bytes
    record["lower_s"] = round(time.time() - t0, 2)

    units = layer_units(cfg)
    u1, u2 = (1, 2) if units >= 2 else (units, units)
    c1, c2 = (with_layer_units(cfg, u) for u in (u1, u2))
    t1 = time.time()
    k1 = card_pass(cell, c1, use_kernel)
    k2 = k1 if u2 == u1 else card_pass(cell, c2, use_kernel)
    record["compile_s"] = round(time.time() - t1, 2)
    t2 = time.time()
    f1 = flop_pass(cell, c1)
    f2 = f1 if u2 == u1 else flop_pass(cell, c2)
    record["measure_s"] = round(time.time() - t2, 2)

    def extrap(a: float, b: float) -> float:
        if u2 == u1:
            return b
        return b + (units - u2) * (b - a) / (u2 - u1)

    flops_dev = extrap(f1, f2)
    bytes_dev = extrap(k1["bytes"], k2["bytes"])
    coll = [rl.collective_total(k["collectives"]) for k in (k1, k2)]
    coll_dev = extrap(*coll)
    outputs = extrap(k1["outputs"], k2["outputs"])
    # each statement's peak extrapolated on its own: where the largest
    # moves with the depth (AdamW's temporaries of the widest leaf at 1
    # and 2 units, the bucketed AllReduce's flat copy deeper), the
    # extrapolated max of the two depths would miss it
    above = [{line: p - k["arguments"] for line, p in
              k["phase_peaks"].items()} for k in (k1, k2)]
    peak = full_args + max(
        extrap(above[0][line], b) if line in above[0] else b
        for line, b in above[1].items())
    record["memory"] = {
        "argument_size_in_bytes": float(full_args),
        "output_size_in_bytes": float(outputs),
        "alias_size_in_bytes": float(extrap(k1["alias"], k2["alias"])),
        "temp_size_in_bytes": float(peak - full_args - outputs),
        "peak_memory_in_bytes": float(peak),
    }
    record["fits"] = bool(peak <= CARD_BYTES)
    record["padding"] = padding_record(cfg, shape, m)
    record["card_bytes"] = CARD_BYTES
    record["cost_scan_counted_once"] = None
    record["hlo_bytes"] = None
    record["measure_points"] = {
        "units": [u1, u2], "full_units": units,
        "flops": [f1, f2], "bytes": [k1["bytes"], k2["bytes"]],
        "collective_bytes": coll,
        "peak_memory_in_bytes": [k1["peak"], k2["peak"]],
        "peak_by_step_line": [{str(line): p for line, p in
                               k["phase_peaks"].items()} for k in (k1, k2)],
        "argument_size_in_bytes": [k1["arguments"], k2["arguments"]],
    }
    record["collectives_u2"] = k2["collectives"]
    record["collectives_by_axis_u2"] = k2["collectives_by_axis"]
    record["cost"] = {"flops": flops_dev, "bytes accessed": bytes_dev}
    record["collective_bytes_per_device"] = coll_dev
    terms = rl.roofline_terms(flops_dev, bytes_dev, coll_dev,
                              record["n_devices"], rl.model_flops(cfg, shape))
    record["roofline"] = {**terms.as_dict(), "priced_for": "TPU v5e (C8)"}
    record["roofline_h100"] = h100_bound(flops_dev, bytes_dev)
    record["status"] = "ok"
    return _finish(record, save)


def h100_bound(flops: float, nbytes: float) -> Dict[str, Any]:
    """The least time one H100 could take for a step of ``flops`` and
    ``nbytes`` (the data sheet's bf16 rate and HBM bandwidth); no
    collective term: no NVLink fit ships (ROADMAP C8)."""
    compute_s, memory_s = flops / H100_PEAK_FLOPS, nbytes / H100_HBM_BW
    return {"priced_for": "H100 SXM data sheet (989 TFLOP/s bf16, "
                          "3.35 TB/s HBM)",
            "compute_s": compute_s, "memory_s": memory_s,
            "bound_s": max(compute_s, memory_s),
            "bound_by": "operations" if compute_s >= memory_s else "bytes"}


def _finish(record: Dict[str, Any], save: bool) -> Dict[str, Any]:
    if save:
        os.makedirs(art_dir(), exist_ok=True)
        tag = f"__{record['tag']}" if record.get("tag") else ""
        path = os.path.join(
            art_dir(),
            f"{record['arch']}__{record['shape']}__{record['mesh']}{tag}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        record["artifact"] = path
    return record


def _use_meta_engine() -> None:
    """Install a fresh engine on the meta device for a cell: the stock
    fabric model (the reference's TPU constants, ROADMAP C8, whatever a
    calibration left in the cache), its decisions kept in memory, never
    written to the cache directory."""
    set_engine(CollectiveEngine(persist=False, device="meta"))


def _one_cell(arch: str, shape: str, mesh_kind: str, skip_existing: bool,
              kwargs: Dict[str, Any]
              ) -> Tuple[Optional[Dict[str, Any]], List[str]]:
    """One cell of :func:`run_cells`: (its record, or None where it was
    skipped as existing; the lines it logs)."""
    tag = kwargs.get("tag", "")
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(art_dir(),
                        f"{arch}__{shape}__{mesh_kind}{suffix}.json")
    if skip_existing and os.path.exists(path):
        return None, [f"[skip] {arch} x {shape} ({mesh_kind}) exists"]
    lines = [f"[cell] {arch} x {shape} ({mesh_kind}) ..."]
    try:
        rec = run_cell(arch, shape, mesh_kind, **kwargs)
    except Exception:       # noqa: BLE001 -- recorded as failed
        lines.append(f"  FAILED:\n{traceback.format_exc()}")
        rec = _finish({"arch": arch, "shape": shape, "mesh": mesh_kind,
                       "tag": tag, "status": "failed",
                       "error": traceback.format_exc()},
                      kwargs.get("save", True))
        return rec, lines
    if rec["status"] == "ok":
        r, h = rec["roofline"], rec["roofline_h100"]
        gb = rec["memory"]["peak_memory_in_bytes"] / 1e9
        pad = rec["padding"]
        padded = ("" if pad.get("heads") == pad.get("padded_heads")
                  else f" heads {pad['heads']} -> {pad['padded_heads']} "
                  f"(pad {pad['pad_flops_share'] * 100:.1f} % of attention "
                  f"FLOPs)")
        if pad["vocab"] != pad["padded_vocab"]:
            padded += f" vocab {pad['vocab']} -> {pad['padded_vocab']}"
        lines.append(
            f"  ok: peak {gb:.3f} GB (fits {rec['fits']}){padded} "
            f"compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
            f"collective={r['collective_s']:.4f}s "
            f"dominant={r['dominant']} (TPU v5e, C8) | H100 bound "
            f"{h['bound_s']:.4f}s ({h['bound_by']}) | "
            f"{rec['compile_s'] + rec['measure_s']:.1f} s")
    else:
        lines.append(f"  {rec['status']}: {rec.get('reason', '')}")
    return rec, lines


def run_cells(cells: Iterable[Tuple[str, str]], mesh_kind: str = "pod",
              skip_existing: bool = False, log: Callable[[str], None] = print,
              workers: int = 1, **kwargs) -> List[Dict[str, Any]]:
    """``run_cell`` over (arch, shape) pairs, each exception written as a
    ``failed`` record with its traceback; the records in order.
    ``workers`` > 1 runs the cells in that many processes (started with
    ``spawn``: a calling script needs its ``__main__`` guard; each cell
    is CPU work on meta tensors), logged in order as they finish."""
    jobs = [(a, s, mesh_kind, skip_existing, kwargs) for a, s in cells]
    records = []
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            results = pool.imap(_star_cell, jobs)
            for rec, lines in results:
                for line in lines:
                    log(line)
                if rec is not None:
                    records.append(rec)
        return records
    for job in jobs:
        rec, lines = _one_cell(*job)
        for line in lines:
            log(line)
        if rec is not None:
            records.append(rec)
    return records


def _star_cell(job):
    return _one_cell(*job)


def status_counts(records: Iterable[Dict[str, Any]]) -> Dict[str, int]:
    out = {"ok": 0, "skipped": 0, "refused": 0, "failed": 0}
    for r in records:
        out[r["status"]] += 1
    return out


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Size every (arch x shape x grid) cell as one rank's "
                    "step on meta tensors (no device needed).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod", choices=sorted(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--scan", action="store_true",
                    help="refused: the port compiles no loop body (the "
                         "reference's scan over layers)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--moe-ep", action="store_true",
                    help="shard_map expert-parallel MoE dispatch")
    ap.add_argument("--attn-bf16", action="store_true",
                    help="bf16 attention probabilities (plain route, C11)")
    ap.add_argument("--logits-bf16", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes to run the cells in")
    args = ap.parse_args(argv)
    if args.scan:
        ap.error("--scan: the port compiles no program, so there is no "
                 "loop body to scan; every cell runs each layer (measured "
                 "at 1 and 2 layer units and extrapolated)")

    archs = list(all_configs()) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    levers = {}
    if args.moe_ep:
        levers["moe_shardmap_ep"] = True
    if args.attn_bf16:
        levers["attn_probs_bf16"] = True
    if args.logits_bf16:
        levers["logits_bf16"] = True
    records = run_cells(
        [(a, s) for a in archs for s in shapes], args.mesh,
        skip_existing=args.skip_existing,
        log=lambda msg: print(msg, flush=True), workers=args.workers,
        microbatches=args.microbatches, fsdp=not args.no_fsdp,
        remat=not args.no_remat, tag=args.tag, levers=levers)
    print(f"[dryrun] {args.mesh}: {status_counts(records)}", flush=True)


__all__ = ["ALLOC_BLOCK", "CARD_BYTES", "H100_HBM_BW", "H100_PEAK_FLOPS",
           "MESHES", "RankStep", "art_dir", "card_pass", "flop_pass",
           "h100_bound", "main", "padding_record", "run_cell", "run_cells",
           "status_counts"]


if __name__ == "__main__":
    main()
