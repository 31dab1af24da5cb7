"""CollectiveEngine: one dispatch layer for all collective traffic.

The port of ``repro/collectives/engine.py`` over one axis.  The paper's
contribution is *model-driven selection*: evaluate every implemented
algorithm under the spatial performance model (Eq. 1) and run the
winner.  The engine makes that a subsystem:

* **Ops** -- ``allreduce``, ``reduce``, ``reduce_scatter``,
  ``allgather``, ``broadcast``, ``all_to_all``, each with fixed-pattern
  backends and (except all_to_all) an Auto-Gen (DP tree) backend,
  selected by ``algorithm="auto"``; and the fused matmul + ring
  reduce-scatter.
* **Decision cache** -- selections are memoized by
  ``(op, P, bytes, fabric)`` and persisted as JSON under the port's own
  cache directory (``REPRO_TORCH_CACHE_DIR``, see
  ``repro_torch.core.autogen.cache_dir``), beside the Auto-Gen npz tables.
* **Tree cache** -- extracted Auto-Gen round schedules are memoized by
  ``(P, elements, fabric)``, so the DP runs once per shape.
* **Multi-axis ops** -- ``allreduce_multi``, ``reduce_scatter_multi``,
  ``allgather_multi`` and ``all_to_all_multi`` run a joint plan of the
  topology planner (``planner.py``: sequential, hierarchical, the
  paper's 2D X-Y and Snake, flat, latency, and the chunk-pipelined
  variants) over a :class:`~repro_torch.collectives.comm.GridComm`;
  plans are memoized by ``(op, axis sizes, bytes, fabric)`` and
  persisted in the decision file's ``plans`` section.

Each op runs on every rank of a :class:`~repro_torch.collectives.comm.Comm`
(where the reference runs inside ``shard_map`` over an axis name)::

    engine.<op>_inside(x, comm, algorithm)
        -> select(op, nbytes, P)                [decision cache]
            -> selector.predict_collective      [model, Eq. 1]
            -> autogen DP (tree cache, npz)     [only if needed]
        -> shardmap_impl backend                [rounds of comm.ppermute]

Selection happens on every rank.  Under ``shard_map`` the reference
selects once per traced call; under :class:`LocalComm` the P rank threads
share one engine, so one call counts 1 miss and P-1 hits in ``stats``
(the lock makes the first rank the one that misses); under
:class:`ProcessGroupComm` each process has its own engine and its own
``stats``, with the reference's meaning per process.  Every rank reaches
the same decision: selection is a pure function of
``(op, P, bytes, fabric)``.  Plans count the same way: one ``*_multi``
call on the ranks of a :func:`~repro_torch.collectives.comm.run_local_grid`
grid is 1 ``plan_misses`` and P-1 ``plan_hits`` for its plan; the
phases' own lookups (per-axis ``select``, the plan of a hierarchical
plan's multi-axis middle phase) add hits and misses the same way.

**Calibration** -- ``calibrate()`` refits the Fabric constants from
timed neighbour shifts (``measure_ppermute`` on a :class:`Comm`, every
axis of a :class:`GridComm` of size > 1) or from given measurements: a
list refits one uniform Fabric, a dict one Fabric per axis on the
fastest axis's time base (a ``FabricTopology``); ``calibrate_launch()``
fits ``Fabric.t_launch`` from measured collective walls (the samples
``obs.replay.measure_spans`` or traced spans give).  A refit clears the
decisions, plans and tree rounds and moves the cache file's name; the
next save records the topology in the v3 ``topology`` section, which
``api.get_engine()`` restores in a later process (unless
``REPRO_TORCH_RESTORE_TOPOLOGY=0``).  On ``LocalComm`` threads a shift
is a barrier and a device copy, not a link (ROADMAP C23).

**Spans** -- with tracing on (``repro_torch.obs``), every public
``*_inside`` and ``*_multi`` op and ``fused_matmul_reduce_scatter``
opens a collective span that ``_resolve`` / ``plan_multi`` annotate with
the decision, and a multi-axis plan's phases nest as phase spans inside
``torch.profiler.record_function`` scopes.  Every rank's span carries
its ``rank``; a port span is always ``mode="eager"`` (ROADMAP C22).
Each op and phase is also a ``repro_torch.collective.<op>[.<phase>]``
profiler range whenever ``torch.profiler`` records, with tracing on or
off (``obs.trace.region``), so a profiler trace times the collectives
from the device without the tracer's synchronising ``measure`` mode.
With both off each op is a call of the plain function.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import math
import os
import threading
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.collectives import planner
from repro_torch.collectives import shardmap_impl as impl
from repro_torch.collectives.comm import Comm, GridComm
from repro_torch.core import patterns as pat
from repro_torch.core import selector
from repro_torch.core.autogen import autogen_tree, cache_dir, compute_tables
from repro_torch.core.model import (Fabric, FabricTopology, TPU_V5E_AXIS,
                                    as_topology, ceil_div)
from repro_torch.device import DeviceLike, resolve_or_meta
from repro_torch.obs import trace as obs_trace

#: one model "element" on the TPU fabric (512-byte flit group).  A TPU
#: figure, kept so that the port's decisions match the reference's.
ICI_ELEMENT_BYTES = 512

#: bump when the cost model changes (patterns/selector) so persisted
#: decisions computed under the old model stop being served (the
#: reference's value: the port prices with the same model).
MODEL_VERSION = 3

#: persisted-file layout version (the reference's v3 layout: decisions
#: keyed by topology signature, the fabric topology in a ``topology``
#: section, the planner's records in a ``plans`` section).
SCHEMA_VERSION = 3

Rounds = Tuple[Tuple[Tuple[int, int], ...], ...]

def _topo_key(op: str, topo: Sequence[int], nbytes: int) -> str:
    return f"{op}|t={'x'.join(str(int(s)) for s in topo)}|B={nbytes}"


def _freeze_rounds(rounds: Sequence[Sequence[Tuple[int, int]]]) -> Rounds:
    return tuple(tuple((int(s), int(d)) for s, d in r) for r in rounds)


@dataclasses.dataclass(frozen=True)
class Decision:
    """One cached selection: what to run for (op, P, bytes)."""

    op: str
    p: int
    nbytes: int
    algorithm: str
    predicted: float
    predictions: Dict[str, float]
    rounds: Optional[Rounds] = None   # Auto-Gen schedule, when selected


def _fit_line(measurements: Sequence[Tuple[int, float]],
              element_bytes: int) -> Tuple[float, float]:
    """Least-squares ``seconds = alpha + beta * B`` over one axis's
    neighbour-shift timings; returns the raw ``(alpha, beta)`` --
    callers decide how to treat a degenerate (non-positive) slope."""
    if len(measurements) < 2:
        raise ValueError("need >= 2 (nbytes, seconds) points to calibrate")
    els = np.array([max(1, nb // element_bytes) for nb, _ in measurements],
                   dtype=np.float64)
    secs = np.array([t for _, t in measurements], dtype=np.float64)
    beta, alpha = np.polyfit(els, secs, 1)
    return float(alpha), float(beta)


def fit_fabric(measurements: Sequence[Tuple[int, float]],
               base: Fabric = TPU_V5E_AXIS, name: Optional[str] = None,
               element_bytes: int = ICI_ELEMENT_BYTES,
               ref_cycle: Optional[float] = None) -> Fabric:
    """Fit Fabric constants from measured one-hop shift timings.

    ``measurements`` is a sequence of ``(nbytes, seconds)`` for a single
    neighbour ppermute.  Under the model a hop costs
    ``(2*t_r + B / link_bw) * cycle`` seconds with B in elements, so a
    least-squares line ``seconds = alpha + beta * B`` recovers the
    constants.  With ``ref_cycle=None`` the axis defines its own time
    base (``t_r = alpha / (2 * beta * base.link_bw)``, ``link_bw =
    base.link_bw``); fitting several axes needs a shared time base: pass
    the fastest axis's beta as ``ref_cycle`` and the fit recovers
    ``link_bw = ref_cycle / beta`` and ``t_r = alpha / (2 * ref_cycle)``
    (the reference's fit, constant for constant)."""
    alpha, beta = _fit_line(measurements, element_bytes)
    beta = max(beta, 1e-30)
    if ref_cycle is None:
        t_r = max(alpha / (2.0 * beta * base.link_bw), 0.0)
        link_bw = base.link_bw
    else:
        ref = max(float(ref_cycle), 1e-30)
        t_r = max(alpha / (2.0 * ref), 0.0)
        link_bw = ref / beta
    return Fabric(name=name or f"{base.name}_calibrated",
                  t_r=t_r, store_cost=base.store_cost,
                  link_bw=link_bw, multicast=base.multicast)


def fit_launch(samples: Sequence[Tuple[str, int, int, str, float]],
               fabric: Fabric = TPU_V5E_AXIS,
               element_bytes: int = ICI_ELEMENT_BYTES
               ) -> Tuple[float, float]:
    """The two-column least squares behind
    :meth:`CollectiveEngine.calibrate_launch`: ``seconds = c * base_i +
    d * L_i`` over ``samples`` of ``(op, p, nbytes, algorithm,
    seconds)``, with ``base_i`` the closed form at ``t_launch = 0`` on
    ``fabric`` and ``L_i`` the launch count.  Returns ``(c, t_launch)``:
    the seconds per model cycle and ``max(d / c, 0)`` in cycles.  Raises
    on fewer than 2 samples, an algorithm without a closed form, equal
    launch counts and a non-positive ``c``, as the reference does."""
    samples = list(samples)
    if len(samples) < 2:
        raise ValueError("calibrate_launch() needs >= 2 samples")
    rows, secs = [], []
    base_fab = dataclasses.replace(fabric, t_launch=0.0)
    for op, p, nbytes, algorithm, seconds in samples:
        b = max(1, int(nbytes) // element_bytes)
        preds = selector.predict_collective(op, int(p), b, base_fab,
                                            include_autogen=False)
        if algorithm not in preds:
            raise ValueError(
                f"calibrate_launch(): no closed form for "
                f"{op!r}/{algorithm!r} at P={p}")
        rows.append((preds[algorithm],
                     pat.launch_count(op, algorithm, int(p))))
        secs.append(float(seconds))
    a = np.array(rows, dtype=np.float64)
    y = np.array(secs, dtype=np.float64)
    if np.ptp(a[:, 1]) == 0.0:
        raise ValueError(
            "calibrate_launch(): all samples have the same launch "
            "count; mix algorithms/sizes so the per-launch column "
            "is identifiable")
    (c, d), *_ = np.linalg.lstsq(a, y, rcond=None)
    if c <= 0.0:
        raise ValueError(
            "calibrate_launch(): non-positive fitted cycle scale; "
            "timings are noise-dominated -- use larger sizes or "
            "more repeats")
    return float(c), max(float(d / c), 0.0)


def measure_ppermute(comm: Comm,
                     sizes_bytes: Sequence[int] = (1 << 12, 1 << 16,
                                                   1 << 20, 1 << 22),
                     repeats: int = 5) -> List[Tuple[int, float]]:
    """Time one neighbour shift (rank i to i + 1, ``comm.ppermute``) per
    size of a float32 payload; feed to :func:`fit_fabric`.

    Every rank of ``comm`` must call it in lockstep, with the same sizes
    and repeats: each shift is a round of the whole group.  Per size one
    warm-up shift, then the best of ``repeats``; on CUDA the comm's
    device is synchronised before each reading of the clock.  The ranks
    then agree on the slowest rank's best per size (an ``all_gather``
    over ``comm``), so every rank returns the same
    ``[(nbytes, seconds), ...]``.  On :class:`LocalComm` threads a shift
    is a barrier and a device copy, not a link (ROADMAP C23)."""
    p = comm.size
    perm = [(i, (i + 1) % p) for i in range(p)]
    cuda = comm.device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(comm.device)

    best_of = []
    for nbytes in sizes_bytes:
        x = torch.zeros(max(1, int(nbytes) // 4), dtype=torch.float32,
                        device=comm.device)
        comm.ppermute(x, perm)
        best = float("inf")
        for _ in range(max(1, repeats)):
            sync()
            t0 = time.perf_counter()
            comm.ppermute(x, perm)
            sync()
            best = min(best, time.perf_counter() - t0)
        best_of.append(best)
    mine = torch.tensor([best_of], dtype=torch.float64, device=comm.device)
    slowest = comm.all_gather(mine).amax(dim=0).tolist()
    return [(int(nb), float(t)) for nb, t in zip(sizes_bytes, slowest)]


def _slowest_over_grid(grid: GridComm,
                       measurements: Dict[str, List[Tuple[int, float]]]
                       ) -> Dict[str, List[Tuple[int, float]]]:
    """Every axis's timings replaced by the slowest over all ranks of
    the grid (each sub-group measured its own rows), so that every rank
    fits the same constants."""
    axes = list(measurements)
    mine = torch.tensor([[t for _, t in measurements[a]] for a in axes],
                        dtype=torch.float64, device=grid.device)
    whole = grid.sub(grid.axis_names)
    slowest = whole.all_gather(mine[None]).amax(dim=0).tolist()
    return {a: [(nb, float(t)) for (nb, _), t in zip(measurements[a], row)]
            for a, row in zip(axes, slowest)}


def fabric_to_dict(f: Fabric) -> Dict[str, Any]:
    return {"name": f.name, "t_r": f.t_r, "store_cost": f.store_cost,
            "link_bw": f.link_bw, "multicast": f.multicast,
            "t_launch": f.t_launch}


def _fabric_from_dict(d: Dict[str, Any]) -> Fabric:
    return Fabric(name=str(d["name"]), t_r=float(d["t_r"]),
                  store_cost=float(d["store_cost"]),
                  link_bw=float(d.get("link_bw", 1.0)),
                  multicast=bool(d.get("multicast", True)),
                  t_launch=float(d.get("t_launch", 0.0)))


def topology_to_dict(t: FabricTopology) -> Dict[str, Any]:
    return {"name": t.name, "default": fabric_to_dict(t.default),
            "axes": {axis: fabric_to_dict(f)
                     for axis, f in t.axis_fabrics}}


def topology_from_dict(d: Dict[str, Any]) -> FabricTopology:
    return FabricTopology(
        default=_fabric_from_dict(d["default"]),
        axis_fabrics=tuple((axis, _fabric_from_dict(fd))
                           for axis, fd in d.get("axes", {}).items()),
        name=str(d.get("name", "")))


def load_topology(path: str) -> Optional[FabricTopology]:
    """Read the fabric topology a cache file was computed under (None
    for an unreadable path or a file without one)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    topo = payload.get("topology")
    if not topo:
        return None
    try:
        return topology_from_dict(topo)
    except (KeyError, TypeError, ValueError):
        return None


def find_calibrated_topology(base: Fabric = TPU_V5E_AXIS
                             ) -> Optional[FabricTopology]:
    """Newest calibrated :class:`FabricTopology` persisted under the
    port's cache directory (never the JAX package's), or None.

    Only *calibrated* topologies (named ``<base>_calibrated`` by
    :meth:`CollectiveEngine.calibrate`) of ``base``'s family qualify, as
    in the reference: a topology declared by a ``--fabric`` spec, or one
    of another fabric family, never leaks into an unrelated process
    sharing the cache directory.  Set ``REPRO_TORCH_RESTORE_TOPOLOGY=0``
    (or ``false``, ``no``, empty; the port's counterpart of the
    reference's ``REPRO_RESTORE_TOPOLOGY``, as ``REPRO_TORCH_CACHE_DIR``
    is of ``REPRO_CACHE_DIR``) to opt out: the process then prices with
    the stock constants whatever a previous calibration left behind."""
    if os.environ.get("REPRO_TORCH_RESTORE_TOPOLOGY", "1").lower() in (
            "0", "false", "no", ""):
        return None
    d = cache_dir()
    try:
        names = os.listdir(d)
    except OSError:
        return None
    paths = [os.path.join(d, n) for n in names
             if n.startswith("engine_decisions__") and n.endswith(".json")]

    def _mtime(p: str) -> float:
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0

    for path in sorted(paths, key=_mtime, reverse=True):
        topo = load_topology(path)
        if topo is None:
            continue
        if not topo.name.endswith("_calibrated"):
            continue        # declared rather than measured
        if topo.is_uniform and topo.default == base:
            continue        # nothing beyond the stock constants
        if (topo.default != base
                and not topo.default.name.startswith(base.name)):
            continue        # a different fabric family's cache
        return topo
    return None


class CollectiveEngine:
    """Cached, model-driven dispatch for every single-axis collective op.

    One engine per fabric-topology parameterization and device;
    ``api.get_engine()`` hands out a process-wide default so all call
    sites share one decision cache.  ``device`` defaults to CUDA (and
    raises without a GPU); every op refuses tensors on another device
    type, so the engine never runs on the CPU unless it was made for it.
    An engine on the meta device runs the dry-run's counting grid
    (``comm.CountingGridComm``): the same decisions and plans on shapes.
    """

    def __init__(self, fabric: "Fabric | FabricTopology" = TPU_V5E_AXIS,
                 cache_path: Optional[str] = None, persist: bool = True,
                 element_bytes: int = ICI_ELEMENT_BYTES,
                 device: DeviceLike = None):
        self.device = resolve_or_meta(device)
        self.topology = as_topology(fabric)
        self.element_bytes = element_bytes
        self._persist = persist
        self._cache_path_override = cache_path
        self._decisions: Dict[str, Decision] = {}
        self._plans: Dict[str, Dict[str, Any]] = {}
        self._tree_rounds: Dict[Tuple[int, int, Fabric], Rounds] = {}
        self._tables: Dict[int, Any] = {}
        self._loaded = False
        self._lock = threading.RLock()
        self._dirty = False
        self._last_save = 0.0
        self.stats = {"hits": 0, "misses": 0, "dp_runs": 0,
                      "persisted_loads": 0, "plan_hits": 0,
                      "plan_misses": 0, "latency_dispatches": 0}
        if persist:
            atexit.register(self.flush)

    @property
    def fabric(self) -> Fabric:
        """The topology's default fabric."""
        return self.topology.default

    # ------------------------------------------------------------------ #
    # decision cache
    # ------------------------------------------------------------------ #
    @staticmethod
    def _fabric_one_tag(f: Fabric) -> str:
        tag = (f"{f.name}_tr{f.t_r:g}_st{f.store_cost:g}"
               f"_bw{f.link_bw:g}_mc{int(f.multicast)}")
        if f.t_launch != 0.0:
            tag += f"_tl{f.t_launch:g}"
        return tag

    def _fabric_tag(self) -> str:
        """Cache namespace: the full topology signature (the reference's
        tag, so a file's name says what constants priced it)."""
        tag = (f"{self._fabric_one_tag(self.topology.default)}"
               f"_eb{self.element_bytes}_v{MODEL_VERSION}")
        for axis, f in self.topology.axis_fabrics:
            tag += f"__{axis}-{self._fabric_one_tag(f)}"
        return tag

    def _cache_path(self) -> str:
        if self._cache_path_override:
            return self._cache_path_override
        return os.path.join(cache_dir(),
                            f"engine_decisions__{self._fabric_tag()}.json")

    def _elements(self, nbytes: int) -> int:
        return max(1, nbytes // self.element_bytes)

    def _load_persisted(self) -> None:
        if self._loaded or not self._persist:
            self._loaded = True
            return
        self._loaded = True
        path = self._cache_path()
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return
        if payload.get("fabric") != self._fabric_tag():
            return
        if int(payload.get("schema", 0)) != SCHEMA_VERSION:
            return     # written by a newer build; recompute instead
        for key, d in payload.get("decisions", {}).items():
            rounds = (_freeze_rounds(d["rounds"])
                      if d.get("rounds") else None)
            self._decisions[key] = Decision(
                op=d["op"], p=int(d["p"]), nbytes=int(d["nbytes"]),
                algorithm=d["algorithm"], predicted=float(d["predicted"]),
                predictions={k: float(v)
                             for k, v in d["predictions"].items()},
                rounds=rounds)
            self.stats["persisted_loads"] += 1
        for key, rec in payload.get("plans", {}).items():
            self._plans[key] = rec
            self.stats["persisted_loads"] += 1

    def _maybe_save(self) -> None:
        """Write-behind: full-file rewrites are throttled to ~1/s;
        ``flush()`` (also registered atexit) writes the tail."""
        if self._dirty and time.monotonic() - self._last_save >= 1.0:
            self._save_persisted()

    def flush(self) -> None:
        """Force any unsaved decisions to disk now."""
        with self._lock:
            if self._dirty:
                self._save_persisted()

    def _save_persisted(self) -> None:
        if not self._persist:
            self._dirty = False
            return
        raw = {}
        for key, d in self._decisions.items():
            raw[key] = {"op": d.op, "p": d.p, "nbytes": d.nbytes,
                        "algorithm": d.algorithm, "predicted": d.predicted,
                        "predictions": d.predictions,
                        "rounds": [[list(s) for s in r] for r in d.rounds]
                        if d.rounds else None}
        try:
            path = self._cache_path()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                json.dump({"schema": SCHEMA_VERSION,
                           "fabric": self._fabric_tag(),
                           "topology": topology_to_dict(self.topology),
                           "decisions": raw, "plans": self._plans}, f)
            os.replace(tmp, path)
        except OSError:
            # unwritable cache dir: selection still works, in memory
            self._persist = False
        self._dirty = False
        self._last_save = time.monotonic()

    def _tables_for(self, p: int):
        tables = self._tables.get(p)
        if tables is None:
            tables = compute_tables(p)
            self._tables[p] = tables
        return tables

    def tree_rounds(self, p: int, b_elements: int,
                    fabric: Optional[Fabric] = None) -> Rounds:
        """Auto-Gen round schedule for (P, B, fabric), DP'd at most
        once; ``fabric`` defaults to the topology's default fabric."""
        fab = fabric or self.topology.default
        with self._lock:
            key = (p, b_elements, fab)
            rounds = self._tree_rounds.get(key)
            if rounds is None:
                self.stats["dp_runs"] += 1
                tree = autogen_tree(p, b_elements, fabric=fab,
                                    tables=self._tables_for(p))
                rounds = _freeze_rounds(tree.to_rounds())
                self._tree_rounds[key] = rounds
            return rounds

    def _fabric_key_suffix(self, fabric: Optional[Fabric]) -> str:
        if fabric is None or fabric == self.topology.default:
            return ""
        return f"|f={self._fabric_one_tag(fabric)}"

    def stats_snapshot(self) -> Dict[str, int]:
        """Atomic copy of the cache counters."""
        with self._lock:
            return dict(self.stats)

    def select(self, op: str, nbytes: int, p: int,
               topo: Optional[Tuple[int, ...]] = None,
               fabric: Optional[Fabric] = None) -> Decision:
        d, _ = self._select_meta(op, nbytes, p, topo=topo, fabric=fabric)
        return d

    def _select_meta(self, op: str, nbytes: int, p: int,
                     topo: Optional[Tuple[int, ...]] = None,
                     fabric: Optional[Fabric] = None
                     ) -> Tuple[Decision, bool]:
        """Model-driven selection, memoized by the topology signature
        ``(op, axis_sizes, bytes, fabric)``; returns the decision and
        whether it came from the cache.

        ``allreduce`` keeps the paper-selector candidate set (fixed
        patterns + ring, no star); the other ops also model their
        Auto-Gen backend (all_to_all has none), so a miss may run the
        DP (counted in ``stats['dp_runs']``)."""
        if p <= 1:
            return Decision(op, p, nbytes, "identity", 0.0, {}), False
        fab = fabric or self.topology.default
        with self._lock:
            self._load_persisted()
            key = (_topo_key(op, topo or (p,), nbytes)
                   + self._fabric_key_suffix(fabric))
            hit = self._decisions.get(key)
            if hit is not None:
                self.stats["hits"] += 1
                return hit, True
            self.stats["misses"] += 1
            b = self._elements(nbytes)
            include_autogen = op not in ("allreduce", "all_to_all")
            tables = self._tables_for(p) if include_autogen else None
            preds = selector.predict_collective(
                op, p, b, fab, include_autogen=include_autogen,
                tables=tables)
            if op == "allreduce":
                # the paper's selector without multicast: star loses to
                # its own broadcast, so it is not a candidate
                preds.pop("star", None)
            name = min(preds, key=preds.get)
            rounds = (self.tree_rounds(p, self._tree_elements(op, b, p),
                                       fabric=fab)
                      if name == "autogen" else None)
            decision = Decision(op, p, nbytes, name, preds[name],
                                {k: float(v) for k, v in preds.items()},
                                rounds)
            self._decisions[key] = decision
            self._dirty = True
            self._maybe_save()
            return decision, False

    def plan_multi(self, op: str, axes: Sequence[str],
                   sizes: Sequence[int], nbytes: int,
                   shape: Optional[str] = None) -> planner.CollectivePlan:
        """The joint plan for an op over an axis tuple of ``sizes``
        (:meth:`_plan_multi_meta` without the cache-hit bit).  Annotates
        the innermost open span on this thread (if any) with the plan
        and its predicted cost."""
        plan, hit = self._plan_multi_meta(op, axes, sizes, nbytes,
                                          shape=shape)
        sp = obs_trace.get_tracer().current_span()
        if getattr(sp, "args", {}).get("plan") is None:
            sp.set(plan=plan.describe(), n_chunks=int(plan.n_chunks),
                   algorithm=str(plan.shape),
                   predicted=float(plan.predicted),
                   cache="hit" if hit else "miss")
            if shape is not None:
                sp.set(algorithm_forced=True)
        return plan

    def _plan_multi_meta(self, op: str, axes: Sequence[str],
                         sizes: Sequence[int], nbytes: int,
                         shape: Optional[str] = None
                         ) -> Tuple[planner.CollectivePlan, bool]:
        """Topology-aware joint plan for an axis tuple, memoized and
        persisted by ``(op, axis_sizes, bytes, fabric)``; returns the
        bound plan and whether its record came from the cache.

        Each axis is priced with its fabric from ``self.topology`` (by
        axis name).  Plans whose axes use non-default fabrics carry
        those constants in the key (``|f=``); uniform topologies rebind
        freely across axis names.  ``shape`` forces a candidate
        (``|shape=`` in the key) instead of the model argmin."""
        axes = tuple(axes)
        sizes = tuple(int(s) for s in sizes)
        if len(axes) != len(sizes):
            raise ValueError(f"axes {axes} vs sizes {sizes}")
        axis_fabrics = tuple(self.topology.for_axis(a) for a in axes)
        with self._lock:
            self._load_persisted()
            key = _topo_key(op, sizes, nbytes)
            if any(f != self.topology.default for f in axis_fabrics):
                key += "|f=" + ",".join(self._fabric_one_tag(f)
                                        for f in axis_fabrics)
            if shape is not None:
                key += f"|shape={shape}"
            rec = self._plans.get(key)
            hit = rec is not None
            if rec is None:
                self.stats["plan_misses"] += 1
                rec = planner.plan_collective(
                    op, sizes, nbytes, self.fabric, self.element_bytes,
                    self.select, force_shape=shape,
                    axis_fabrics=axis_fabrics)
                self._plans[key] = rec
                self._dirty = True
                self._maybe_save()
            else:
                self.stats["plan_hits"] += 1
        return planner.bind_plan(rec, op, axes), hit

    def clear_cache(self) -> None:
        with self._lock:
            self._decisions.clear()
            self._plans.clear()
            self._tree_rounds.clear()
            self._tables.clear()
            self._loaded = False

    def decision_table(self) -> List[Decision]:
        """Everything decided so far (introspection/reporting)."""
        with self._lock:
            self._load_persisted()
            return sorted(self._decisions.values(),
                          key=lambda d: (d.op, d.p, d.nbytes))

    # ------------------------------------------------------------------ #
    # calibration
    # ------------------------------------------------------------------ #
    def _refit(self, topology: FabricTopology) -> None:
        """Install refitted constants: the cache namespace (file name)
        moves with them, and the in-memory decisions, plans and tree
        rounds predate them."""
        self.topology = topology
        self._decisions.clear()
        self._plans.clear()
        self._tree_rounds.clear()
        self._loaded = False

    def calibrate(self, measurements: Optional[Any] = None,
                  grid: Optional[GridComm] = None,
                  axis: Optional[str] = None,
                  sizes_bytes: Sequence[int] = (1 << 12, 1 << 16, 1 << 20,
                                                1 << 22)
                  ) -> "Fabric | FabricTopology":
        """Refit the fabric constants from timings and drop stale
        decisions.

        * ``measurements=[(nbytes, seconds), ...]`` -- refit the default
          fabric (uniform topology); returns the fitted :class:`Fabric`.
        * ``measurements={axis: [(nbytes, seconds), ...], ...}`` -- fit
          one Fabric *per axis* on a shared time base: the fastest
          axis's fitted cycle anchors ``link_bw=1`` and slower axes get
          proportionally smaller ``link_bw`` (and their own ``t_r``).
          Returns the new :class:`FabricTopology`.
        * ``grid=...`` (this rank's :class:`GridComm`, where the
          reference takes a mesh) -- :func:`measure_ppermute` on
          ``grid.sub(a)`` for every axis of size > 1 (or just ``axis``),
          at ``sizes_bytes``, best of 5; every rank of the
          grid must call it in lockstep, and all fit the slowest rank's
          timings, so every rank (or every thread sharing this engine)
          installs the same constants.  Fitted per axis as above.

        Either way the engine's cache namespace moves to the new
        constants; the next persisted save records the topology in the
        v3 ``topology`` section.  A noise-dominated (non-positive or
        vanishing) slope on any axis of a dict raises, naming the axes,
        and leaves the engine as it was: raise ``sizes_bytes``."""
        if measurements is None:
            if grid is None:
                raise ValueError("calibrate() needs measurements or a grid")
            axes = ([axis] if axis is not None
                    else [a for a in grid.axis_names
                          if grid.axis_size(a) > 1])
            if not axes:
                raise ValueError(
                    f"calibrate(grid=...): no axis of size > 1 to "
                    f"measure in grid "
                    f"{dict(zip(grid.axis_names, grid.shape))}")
            measurements = _slowest_over_grid(grid, {
                a: measure_ppermute(grid.sub(a), sizes_bytes)
                for a in axes})
        with self._lock:
            base = self.topology.default
            if isinstance(measurements, dict):
                if not measurements:
                    raise ValueError("calibrate() got an empty per-axis "
                                     "measurements dict")
                lines = {a: _fit_line(m, self.element_bytes)
                         for a, m in measurements.items()}
                # a non-positive -- or vanishing -- fitted slope means
                # the timings carry no bandwidth signal; anchoring the
                # shared time base on it would poison every axis's
                # constants -- fail loudly
                bad = []
                for a, m in measurements.items():
                    alpha, beta = lines[a]
                    els = [max(1, nb // self.element_bytes)
                           for nb, _ in m]
                    rise = beta * (max(els) - min(els))
                    scale = abs(alpha) + abs(beta) * max(els) + 1e-30
                    if beta <= 0.0 or rise < 1e-6 * scale:
                        bad.append(a)
                bad.sort()
                if bad:
                    raise ValueError(
                        f"calibrate(): non-positive fitted slope for "
                        f"axis(es) {bad}; timings are noise-dominated "
                        f"-- raise sizes_bytes/repeats or calibrate "
                        f"those axes separately")
                # shared time base: the fastest axis's seconds/element
                ref = min(beta for _, beta in lines.values())
                fitted = tuple(
                    (a, fit_fabric(measurements[a], base=base,
                                   name=f"{base.name}_{a}",
                                   element_bytes=self.element_bytes,
                                   ref_cycle=ref))
                    for a in sorted(measurements))
                result: "Fabric | FabricTopology" = FabricTopology(
                    default=base, axis_fabrics=fitted,
                    name=f"{base.name}_calibrated")
                self._refit(result)
            else:
                fitted_f = fit_fabric(measurements, base=base,
                                      element_bytes=self.element_bytes)
                self._refit(FabricTopology.uniform(fitted_f))
                result = fitted_f
        return result

    def calibrate_launch(self,
                         samples: Sequence[Tuple[str, int, int, str, float]]
                         ) -> float:
        """Fit ``Fabric.t_launch`` from measured collective wall times.

        ``samples`` is ``[(op, p, nbytes, algorithm, seconds), ...]`` --
        what ``obs.replay.measure_spans`` or measured spans give
        (``nbytes`` in the model's convention: global bytes for
        allgather).  Under the model a run costs ``seconds = cycle *
        (base_i + t_launch * L_i)``, ``base_i`` the closed form at
        ``t_launch = 0`` and ``L_i`` the number of sequential launches
        (:func:`patterns.launch_count`); :func:`fit_launch` solves for
        the seconds per cycle and the per-launch seconds.  Mixing sizes
        *and* algorithms with different launch counts makes the two
        columns separable.

        The engine's topology moves to the fitted constant (every
        per-axis fabric gets the same ``t_launch``), the cache namespace
        moves with it, and stale decisions are dropped.  Returns the
        fitted ``t_launch`` (cycles, >= 0)."""
        _, t_launch = fit_launch(samples, self.topology.default,
                                 self.element_bytes)
        with self._lock:
            new_default = dataclasses.replace(self.topology.default,
                                              t_launch=t_launch)
            new_axes = tuple(
                (axis, dataclasses.replace(f, t_launch=t_launch))
                for axis, f in self.topology.axis_fabrics)
            self._refit(FabricTopology(default=new_default,
                                       axis_fabrics=new_axes,
                                       name=self.topology.name))
        return t_launch

    # ------------------------------------------------------------------ #
    # dispatch: *_inside run on every rank of a Comm
    # ------------------------------------------------------------------ #
    @staticmethod
    def _tree_elements(op: str, b: int, p: int) -> int:
        """Vector length the Auto-Gen DP should optimize for: the
        chunked ops run the tree per B/P-element chunk."""
        if op in ("reduce_scatter", "allgather"):
            return max(1, -(-b // p))
        return b

    def _resolve(self, op: str, nbytes: int, p: int, algorithm: str,
                 axis: Any = None) -> Tuple[str, Optional[Rounds]]:
        """``nbytes`` is always the GLOBAL vector size the cost model is
        written in terms of (callers of allgather pass shard * P);
        ``axis`` resolves the axis-local fabric."""
        fab = self.topology.for_axis(axis)
        # annotate the innermost open span -- first writer wins, so a
        # nested resolution (allreduce -> reduce) never overwrites the
        # outer op's decision on the outer op's span
        sp = obs_trace.get_tracer().current_span()
        if getattr(sp, "args", {}).get("algorithm") is not None:
            sp = obs_trace.NULL_SPAN
        if algorithm == "auto":
            d, hit = self._select_meta(op, nbytes, p, fabric=fab)
            sp.set(algorithm=d.algorithm, predicted=float(d.predicted),
                   cache="hit" if hit else "miss",
                   regime=("latency" if d.algorithm == "oneshot"
                           else "bandwidth"))
            if d.algorithm == "oneshot":
                with self._lock:
                    self.stats["latency_dispatches"] += 1
            return d.algorithm, d.rounds
        sp.set(algorithm=algorithm, algorithm_forced=True, cache="forced",
               regime="latency" if algorithm == "oneshot" else "bandwidth")
        if algorithm == "oneshot":
            with self._lock:
                self.stats["latency_dispatches"] += 1
        if algorithm in ("autogen", "autogen_pipelined"):
            b = self._tree_elements(op, self._elements(nbytes), p)
            return algorithm, self.tree_rounds(p, b, fabric=fab)
        return algorithm, None

    def _check(self, x: torch.Tensor, comm: Comm) -> None:
        if x.device.type != self.device.type:
            raise ValueError(f"CollectiveEngine on {self.device} got a "
                             f"tensor on {x.device}")
        if comm.device.type != self.device.type:
            raise ValueError(f"CollectiveEngine on {self.device} got a "
                             f"communicator on {comm.device}")

    @staticmethod
    def _nbytes(x: torch.Tensor) -> int:
        return x.numel() * x.element_size()

    # ------------------------------------------------------------------ #
    # span plumbing: every public collective opens one CAT_COLLECTIVE
    # span; `_resolve` / `plan_multi` annotate it with the decision
    # ------------------------------------------------------------------ #
    @staticmethod
    def _comm_axes(comm: Comm) -> Tuple[Tuple[str, ...], Tuple[int, ...],
                                        int]:
        """A comm's axis names, their sizes and this rank's rank in the
        grid it was cut from (its own rank for a bare comm)."""
        axis = comm.axis
        if axis is None:
            names: Tuple[str, ...] = ()
        elif isinstance(axis, str):
            names = (axis,)
        else:
            names = tuple(str(a) for a in axis)
        sizes = comm.axis_sizes or (comm.size,)
        rank = comm.rank if comm.grid_rank is None else comm.grid_rank
        return names, tuple(int(s) for s in sizes), int(rank)

    def _traced(self, name: str, op: str, where: Union[Comm, GridComm],
                axes: Optional[Tuple[str, ...]], nbytes: int,
                algorithm: str, run: Callable[[], torch.Tensor],
                decided: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """``run()`` inside a collective span carrying every key the
        trace schema requires (so a span conforms even when the op
        bypasses the model: :meth:`_finish_collective` fills the rest).
        ``where`` is the comm of a single-axis op, or the grid of a
        multi-axis one over ``axes``; ``decided`` annotates the span
        before the run (a decision made outside ``_resolve``).  The
        call is a ``repro_torch.collective.<op>`` region: a profiler
        range whenever the profiler records, with or without the span;
        with both off, ``run()`` alone."""
        scope = f"repro_torch.collective.{op}"
        if not obs_trace.get_tracer().enabled:
            with obs_trace.region(scope):
                return run()
        if axes is None:
            names, sizes, rank = self._comm_axes(where)
        else:
            names = axes
            sizes = tuple(where.axis_size(a) for a in axes)
            rank = where.rank
        with obs_trace.region(
                scope, label=name, cat=obs_trace.CAT_COLLECTIVE, op=op,
                axes=names, axis_sizes=sizes, bytes=int(nbytes),
                requested=str(algorithm), plan=None, algorithm=None,
                cache=None, predicted=None, measured_s=None, mode=None,
                rank=rank) as sp:
            if decided:
                sp.set(**decided)
            out = run()
            self._finish_collective(sp, out, algorithm)
            return out

    @staticmethod
    def _finish_collective(sp, out: torch.Tensor, requested: str) -> None:
        """Close out a collective span: paths that never reached the
        model (natives, size-1 axes) stamp the requested algorithm as
        forced, then the result stamps the mode and the wall time."""
        span = getattr(sp, "span", None)
        if span is not None and span.args.get("algorithm") is None:
            sp.set(algorithm=str(requested), algorithm_forced=True,
                   cache="forced")
        sp.finish_result(out)

    def reduce_inside(self, x: torch.Tensor, comm: Comm,
                      algorithm: str = "auto") -> torch.Tensor:
        """Paper Reduce: the full sum lands on rank 0 of the axis."""
        return self._traced("reduce_inside", "reduce", comm, None,
                            self._nbytes(x), algorithm,
                            lambda: self._reduce_inside(x, comm, algorithm))

    def _reduce_inside(self, x: torch.Tensor, comm: Comm,
                       algorithm: str = "auto") -> torch.Tensor:
        self._check(x, comm)
        p = comm.size
        if p == 1:
            return x
        algorithm, rounds = self._resolve("reduce", self._nbytes(x), p,
                                          algorithm, comm.axis)
        if algorithm in impl.REDUCE_FNS:
            return impl.REDUCE_FNS[algorithm](x, comm)
        if algorithm == "autogen":
            return impl.schedule_reduce(x, comm, rounds)
        if algorithm == "autogen_pipelined":
            flat = x.reshape(-1)
            out = impl.schedule_reduce_pipelined(flat, comm, rounds)
            return out.reshape(x.shape)
        raise ValueError(f"unknown reduce algorithm {algorithm!r}")

    def allreduce_inside(self, x: torch.Tensor, comm: Comm,
                         algorithm: str = "auto") -> torch.Tensor:
        return self._traced(
            "allreduce_inside", "allreduce", comm, None, self._nbytes(x),
            algorithm, lambda: self._allreduce_inside(x, comm, algorithm))

    def _allreduce_inside(self, x: torch.Tensor, comm: Comm,
                          algorithm: str = "auto") -> torch.Tensor:
        self._check(x, comm)
        if algorithm == "psum":
            return comm.psum(x)
        p = comm.size
        if p == 1:
            return x
        algorithm, rounds = self._resolve("allreduce", self._nbytes(x), p,
                                          algorithm, comm.axis)
        if algorithm == "oneshot":
            # the latency regime: one native collective, depth 1
            return comm.psum(x)
        if algorithm == "ring":
            flat = x.reshape(-1)
            return impl.ring_allreduce(flat, comm).reshape(x.shape)
        red = self._reduce_inside(x, comm, algorithm)
        return impl.broadcast(red, comm, root=0)

    def reduce_scatter_inside(self, x: torch.Tensor, comm: Comm,
                              algorithm: str = "auto") -> torch.Tensor:
        """Sum over the axis, shard the result: rank i gets chunk i
        (``lax.psum_scatter(..., tiled=True)`` semantics; leading dim
        divisible by P)."""
        return self._traced(
            "reduce_scatter_inside", "reduce_scatter", comm, None,
            self._nbytes(x), algorithm,
            lambda: self._reduce_scatter_inside(x, comm, algorithm))

    def _reduce_scatter_inside(self, x: torch.Tensor, comm: Comm,
                               algorithm: str = "auto") -> torch.Tensor:
        self._check(x, comm)
        p = comm.size
        if p == 1:
            return x
        rounds = None
        if algorithm != "psum_scatter":
            algorithm, rounds = self._resolve(
                "reduce_scatter", self._nbytes(x), p, algorithm, comm.axis)
        if algorithm == "psum_scatter":
            return comm.psum_scatter(x)
        if algorithm == "ring":
            return impl.reduce_scatter_ring(x, comm)
        if algorithm == "autogen":
            return impl.schedule_reduce_scatter(x, comm, rounds)
        raise ValueError(f"unknown reduce_scatter algorithm {algorithm!r}")

    def allgather_inside(self, x: torch.Tensor, comm: Comm,
                         algorithm: str = "auto") -> torch.Tensor:
        """Gather shards along the axis into the leading dim
        (``lax.all_gather(..., tiled=True)`` semantics)."""
        # the span (like the cost model) records the GLOBAL gathered
        # bytes, shard * P -- the replayer relies on this convention
        return self._traced(
            "allgather_inside", "allgather", comm, None,
            self._nbytes(x) * comm.size, algorithm,
            lambda: self._allgather_inside(x, comm, algorithm))

    def _allgather_inside(self, x: torch.Tensor, comm: Comm,
                          algorithm: str = "auto") -> torch.Tensor:
        self._check(x, comm)
        p = comm.size
        if p == 1:
            return x
        rounds = None
        if algorithm != "all_gather":
            # x is the local shard; the cost model prices the global
            # gather, so scale by P
            algorithm, rounds = self._resolve(
                "allgather", self._nbytes(x) * p, p, algorithm, comm.axis)
        if algorithm in ("all_gather", "oneshot"):
            return comm.all_gather(x)
        if algorithm == "ring":
            return impl.allgather_ring(x, comm)
        if algorithm == "doubling":
            return impl.allgather_doubling(x, comm)
        if algorithm == "autogen":
            return impl.schedule_allgather(x, comm, rounds)
        raise ValueError(f"unknown allgather algorithm {algorithm!r}")

    def all_to_all_inside(self, x: torch.Tensor, comm: Comm,
                          algorithm: str = "auto") -> torch.Tensor:
        """Personalized exchange along the axis: ``lax.all_to_all(x,
        axis, split_axis=0, concat_axis=0, tiled=True)`` semantics.
        ``algorithm``: ``lax`` (the native), ``ring`` (pairwise
        exchange), ``halving`` (Bruck), or ``auto`` (model argmin)."""
        return self._traced(
            "all_to_all_inside", "all_to_all", comm, None, self._nbytes(x),
            algorithm, lambda: self._all_to_all_inside(x, comm, algorithm))

    def _all_to_all_inside(self, x: torch.Tensor, comm: Comm,
                           algorithm: str = "auto") -> torch.Tensor:
        self._check(x, comm)
        p = comm.size
        if p == 1:
            return x
        if algorithm == "lax":
            return comm.all_to_all(x)
        algorithm, _ = self._resolve("all_to_all", self._nbytes(x), p,
                                     algorithm, comm.axis)
        if algorithm == "oneshot":
            return comm.all_to_all(x)
        if algorithm == "ring":
            return impl.all_to_all_ring(x, comm)
        if algorithm == "halving":
            return impl.all_to_all_bruck(x, comm)
        raise ValueError(f"unknown all_to_all algorithm {algorithm!r}")

    def broadcast_inside(self, x: torch.Tensor, comm: Comm, root: int = 0,
                         algorithm: str = "auto") -> torch.Tensor:
        return self._traced(
            "broadcast_inside", "broadcast", comm, None, self._nbytes(x),
            algorithm,
            lambda: self._broadcast_inside(x, comm, root, algorithm))

    def _broadcast_inside(self, x: torch.Tensor, comm: Comm, root: int,
                          algorithm: str) -> torch.Tensor:
        self._check(x, comm)
        p = comm.size
        if p == 1:
            return x
        algorithm, rounds = self._resolve("broadcast", self._nbytes(x), p,
                                          algorithm, comm.axis)
        if algorithm == "doubling":
            return impl.broadcast(x, comm, root=root)
        if algorithm == "chain":
            return impl.chain_broadcast(x, comm, root=root)
        if algorithm == "autogen":
            if root != 0:
                rounds = impl._rotate_rounds(rounds, p, root)
            seeded = x if comm.rank == root else torch.zeros_like(x)
            return impl.schedule_broadcast(seeded, comm, rounds)
        raise ValueError(f"unknown broadcast algorithm {algorithm!r}")

    # ------------------------------------------------------------------ #
    # multi-axis dispatch: planner-driven joint plans over a grid's axes.
    # Each op runs on every rank of a GridComm; a plan's phases run on
    # the grid's sub-comms (``grid.sub(axes)``), as the reference's run
    # under shard_map over mesh axis names.
    # ------------------------------------------------------------------ #
    @staticmethod
    def _grid_axes(grid: GridComm, axes: Any
                   ) -> Tuple[Tuple[str, ...], Tuple[int, ...], int]:
        """``axes`` as a tuple, their sizes and their product."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        sizes = tuple(grid.axis_size(a) for a in axes)
        return axes, sizes, math.prod(sizes)

    @staticmethod
    def _chunk_transpose(x: torch.Tensor, sizes: Sequence[int]
                         ) -> torch.Tensor:
        """Reorder leading-dim chunks from row-major blocks over
        ``sizes`` to row-major blocks over ``reversed(sizes)`` -- the
        permutation that makes the innermost-first reduce-scatter
        cascade land chunks in ``psum_scatter`` (rank-major) order."""
        k = len(sizes)
        blocks = x.reshape(tuple(sizes) + (-1,) + tuple(x.shape[1:]))
        perm = tuple(reversed(range(k))) + tuple(range(k, blocks.dim()))
        return blocks.permute(perm).reshape(x.shape)

    @staticmethod
    def _phase_names(steps: Sequence[planner.PlanStep]) -> List[str]:
        """Human labels for a plan's phases, mirroring
        ``CollectivePlan.describe()`` per step."""
        return [
            f"{planner._KIND_ABBREV.get(s.kind, s.kind)}:"
            f"{s.algorithm}@{'x'.join(s.axes)}"
            for s in steps]

    @staticmethod
    def _run_phases(chunks: List[torch.Tensor],
                    phase_fns: Sequence[Callable[[torch.Tensor],
                                                 torch.Tensor]],
                    op: Optional[str] = None,
                    phase_names: Optional[Sequence[str]] = None
                    ) -> List[torch.Tensor]:
        """Run ``phase_fns`` over payload ``chunks`` in the reference's
        wavefront order: in wave ``w``, chunk ``k`` runs phase ``w - k``.
        The chunks are data-independent; every rank issues the same
        sequence of collectives, one at a time, so the wavefront orders
        the calls but does not overlap them.  With a single chunk the
        phases run back to back.

        Each phase call is a ``repro_torch.collective.<op>.<phase>``
        region (the reference's ``jax.named_scope``): a profiler range
        whenever the profiler records and, with tracing on, a nested
        CAT_PHASE span; neither ever synchronises, whatever the tracer's
        measurement mode."""
        chunks = list(chunks)
        n = len(phase_fns)
        for wave in range(n + len(chunks) - 1):
            for k in range(len(chunks)):
                r = wave - k
                if not 0 <= r < n:
                    continue
                label = (phase_names[r]
                         if phase_names and r < len(phase_names)
                         else f"phase{r}")
                scope = ".".join(filter(None, (
                    "repro_torch.collective", op, label.replace(":", "_"))))
                with obs_trace.region(scope, label=label,
                                      cat=obs_trace.CAT_PHASE, op=op,
                                      phase=r, chunk=k, wave=wave) as sp:
                    chunks[k] = phase_fns[r](chunks[k])
                    sp.finish_result(chunks[k], block=False)
        return chunks

    @staticmethod
    def _split_row_chunks(x: torch.Tensor, p: int, c: int
                          ) -> Tuple[List[torch.Tensor], int]:
        """Slice ``x`` ([p*m, ...], p row-major rank blocks) into ``c``
        chunks of ``[p*mc, ...]``, chunk ``k`` carrying rows
        ``[k*mc, (k+1)*mc)`` of every rank block (zero-padded when ``c``
        does not divide m).  Returns the chunks and m."""
        m = x.shape[0] // p
        mc = ceil_div(m, c)
        tail = tuple(x.shape[1:])
        blocks = x.reshape((p, m) + tail)
        pad = c * mc - m
        if pad:
            blocks = torch.cat([blocks, blocks.new_zeros((p, pad) + tail)],
                               dim=1)
        return [blocks[:, k * mc:(k + 1) * mc].reshape((p * mc,) + tail)
                for k in range(c)], m

    @staticmethod
    def _join_row_chunks(chunks: List[torch.Tensor], p: int, m: int
                         ) -> torch.Tensor:
        """Inverse of :meth:`_split_row_chunks` on the output side:
        chunk ``k`` holds rows ``[k*mc, (k+1)*mc)`` of every rank block
        of the [p*m, ...] result (pad rows dropped)."""
        mc = chunks[0].shape[0] // p
        tail = tuple(chunks[0].shape[1:])
        parts = [ch.reshape((p, mc) + tail) for ch in chunks]
        out = torch.cat(parts, dim=1)[:, :m]
        return out.reshape((p * m,) + tail)

    def allreduce_multi(self, x: torch.Tensor, grid: GridComm,
                        axes: Sequence[str], algorithm: str = "auto"
                        ) -> torch.Tensor:
        """AllReduce over a tuple of the grid's axes through a joint
        topology plan.

        ``algorithm`` is ``"auto"`` (planner argmin), a plan shape
        (``"sequential" | "hierarchical" | "2d_xy" | "2d_snake" |
        "flat" | "latency"`` or a ``*_pipelined`` variant, run over
        ``plan.n_chunks`` payload slices), ``"psum"`` (the native over
        the folded axes), or a 1D backend name, which runs that backend
        on every axis, innermost first."""
        axes = self._grid_axes(grid, axes)[0]
        if len(axes) == 1:
            return self.allreduce_inside(x, grid.sub(axes), algorithm)
        return self._traced(
            "allreduce_multi", "allreduce", grid, axes, self._nbytes(x),
            algorithm, lambda: self._allreduce_multi(x, grid, axes,
                                                     algorithm))

    def _allreduce_multi(self, x: torch.Tensor, grid: GridComm,
                         axes: Tuple[str, ...], algorithm: str
                         ) -> torch.Tensor:
        axes, sizes, _ = self._grid_axes(grid, axes)
        self._check(x, grid)
        if algorithm == "psum":
            return grid.sub(axes).psum(x)
        if all(s == 1 for s in sizes):
            return x
        nbytes = self._nbytes(x)
        if algorithm == "auto" or algorithm in planner.ALLREDUCE_SHAPES:
            shape = None if algorithm == "auto" else algorithm
            plan = self.plan_multi("allreduce", axes, sizes, nbytes,
                                   shape=shape)
            return self._run_allreduce_plan(x, grid, plan)
        for ax in reversed(axes):
            x = self.allreduce_inside(x, grid.sub(ax), algorithm)
        return x

    def _run_allreduce_plan(self, x: torch.Tensor, grid: GridComm,
                            plan: planner.CollectivePlan) -> torch.Tensor:
        if plan.shape == "identity":
            return x
        if plan.shape == "2d_xy":
            (step,) = plan.steps
            patterns = tuple(step.algorithm.split("x"))
            return impl.xy_allreduce_2d(x, grid, step.axes, patterns)
        if plan.shape == "2d_snake":
            (step,) = plan.steps
            return impl.snake_allreduce_2d(x, grid, step.axes)
        if plan.shape in ("flat", "latency"):
            # one step over the folded axis tuple; "latency" carries the
            # "oneshot" algorithm, one native collective
            (step,) = plan.steps
            return self.allreduce_inside(x, grid.sub(step.axes),
                                         step.algorithm)
        base = planner.base_shape(plan.shape)
        if base not in ("sequential", "hierarchical"):
            raise ValueError(f"unknown plan shape {plan.shape!r}")
        shape0 = x.shape
        flat = x.reshape(-1)
        n = flat.numel()
        c = max(1, plan.n_chunks)
        chunk_len = ceil_div(n, c)
        pad = c * chunk_len - n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        chunks = [flat[k * chunk_len:(k + 1) * chunk_len] for k in range(c)]
        fns = self._allreduce_phase_fns(grid, plan, base, chunk_len)
        chunks = self._run_phases(chunks, fns, op="allreduce",
                                  phase_names=self._phase_names(plan.steps))
        out = torch.cat(chunks) if c > 1 else chunks[0]
        if pad:
            out = out[:n]
        return out.reshape(shape0)

    def _allreduce_phase_fns(self, grid: GridComm,
                             plan: planner.CollectivePlan, base: str,
                             chunk_len: int
                             ) -> List[Callable[[torch.Tensor],
                                                torch.Tensor]]:
        """Per-phase closures mapping a flat ``[chunk_len]`` slice to its
        reduced ``[chunk_len]``: the executable form of a sequential or
        hierarchical allreduce plan, fed to :meth:`_run_phases`."""
        if base == "sequential":
            return [
                (lambda v, s=step: self.allreduce_inside(
                    v, grid.sub(s.axes[0]), s.algorithm))
                for step in plan.steps]
        rs, mid, ag = plan.steps
        inner = grid.sub(rs.axes[0])
        pad = (-chunk_len) % inner.size

        def f_rs(v):
            if pad:
                v = torch.cat([v, v.new_zeros(pad)])
            return self.reduce_scatter_inside(v, inner, rs.algorithm)

        def f_mid(v):
            return self.allreduce_multi(v, grid, mid.axes, mid.algorithm)

        def f_ag(v):
            v = self.allgather_inside(v, inner, ag.algorithm)
            return v[:chunk_len] if pad else v

        return [f_rs, f_mid, f_ag]

    def reduce_scatter_multi(self, x: torch.Tensor, grid: GridComm,
                             axes: Sequence[str], algorithm: str = "auto"
                             ) -> torch.Tensor:
        """Sum over the folded axes, shard the result rank-major
        (``lax.psum_scatter(x, axes, tiled=True)`` semantics; leading
        dim divisible by the folded size).  ``algorithm``: ``"auto"``, a
        plan shape (``cascade``, ``flat``, ``cascade_pipelined``) or
        ``"psum_scatter"`` (the native)."""
        axes = self._grid_axes(grid, axes)[0]
        if len(axes) == 1:
            return self.reduce_scatter_inside(x, grid.sub(axes), algorithm)
        return self._traced(
            "reduce_scatter_multi", "reduce_scatter", grid, axes,
            self._nbytes(x), algorithm,
            lambda: self._reduce_scatter_multi(x, grid, axes, algorithm))

    def _reduce_scatter_multi(self, x: torch.Tensor, grid: GridComm,
                              axes: Tuple[str, ...], algorithm: str
                              ) -> torch.Tensor:
        axes, sizes, p = self._grid_axes(grid, axes)
        self._check(x, grid)
        if algorithm == "psum_scatter":
            return grid.sub(axes).psum_scatter(x)
        if p == 1:
            return x
        if x.shape[0] % p:
            raise ValueError(f"leading dim {x.shape[0]} is not divisible "
                             f"by the folded size {p}")
        shape = None if algorithm == "auto" else algorithm
        plan = self.plan_multi("reduce_scatter", axes, sizes,
                               self._nbytes(x), shape=shape)
        if plan.shape == "flat":
            (step,) = plan.steps
            return self.reduce_scatter_inside(x, grid.sub(step.axes),
                                              step.algorithm)
        # cascade: pre-permute chunks so the innermost-first shrink lands
        # each rank on its psum_scatter chunk; a pipelined plan slices
        # each rank block's rows and wavefronts the phases
        steps = plan.steps

        def f0(v, s=steps[0]):
            return self.reduce_scatter_inside(
                self._chunk_transpose(v, sizes), grid.sub(s.axes[0]),
                s.algorithm)

        fns = [f0] + [
            (lambda v, s=step: self.reduce_scatter_inside(
                v, grid.sub(s.axes[0]), s.algorithm))
            for step in steps[1:]]
        names = self._phase_names(steps)
        c = max(1, plan.n_chunks)
        if c == 1:
            return self._run_phases([x], fns, op="reduce_scatter",
                                    phase_names=names)[0]
        chunks, m = self._split_row_chunks(x, p, c)
        chunks = self._run_phases(chunks, fns, op="reduce_scatter",
                                  phase_names=names)
        return torch.cat(chunks, dim=0)[:m]

    def allgather_multi(self, x: torch.Tensor, grid: GridComm,
                        axes: Sequence[str], algorithm: str = "auto"
                        ) -> torch.Tensor:
        """Gather rank-major shards along the folded axes into the
        leading dim (``lax.all_gather(x, axes, tiled=True)`` semantics).
        ``algorithm``: ``"auto"``, a plan shape (``cascade``, ``flat``,
        ``latency``, ``cascade_pipelined``) or ``"all_gather"`` (the
        native)."""
        axes, _, p = self._grid_axes(grid, axes)
        if len(axes) == 1:
            return self.allgather_inside(x, grid.sub(axes), algorithm)
        # global gathered bytes, matching the model's B and the replayer
        return self._traced(
            "allgather_multi", "allgather", grid, axes,
            self._nbytes(x) * p, algorithm,
            lambda: self._allgather_multi(x, grid, axes, algorithm))

    def _allgather_multi(self, x: torch.Tensor, grid: GridComm,
                         axes: Tuple[str, ...], algorithm: str
                         ) -> torch.Tensor:
        axes, sizes, p = self._grid_axes(grid, axes)
        self._check(x, grid)
        if algorithm == "all_gather":
            return grid.sub(axes).all_gather(x)
        if p == 1:
            return x
        shape = None if algorithm == "auto" else algorithm
        plan = self.plan_multi("allgather", axes, sizes,
                               self._nbytes(x) * p, shape=shape)
        if plan.shape in ("flat", "latency"):
            (step,) = plan.steps
            return self.allgather_inside(x, grid.sub(step.axes),
                                         step.algorithm)
        # cascade: outermost-first growth, then undo the chunk
        # permutation the matching reduce-scatter cascade applied; a
        # pipelined plan slices the shard's rows and wavefronts
        steps = plan.steps

        def f_last(v, s=steps[-1]):
            return self._chunk_transpose(
                self.allgather_inside(v, grid.sub(s.axes[0]), s.algorithm),
                tuple(reversed(sizes)))

        fns = [
            (lambda v, s=step: self.allgather_inside(
                v, grid.sub(s.axes[0]), s.algorithm))
            for step in steps[:-1]] + [f_last]
        names = self._phase_names(steps)
        c = max(1, plan.n_chunks)
        if c == 1:
            return self._run_phases([x], fns, op="allgather",
                                    phase_names=names)[0]
        s_len = x.shape[0]
        sc = ceil_div(s_len, c)
        pad = c * sc - s_len
        xp = x
        if pad:
            xp = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        chunks = [xp[k * sc:(k + 1) * sc] for k in range(c)]
        chunks = self._run_phases(chunks, fns, op="allgather",
                                  phase_names=names)
        return self._join_row_chunks(chunks, p, s_len)

    def all_to_all_multi(self, x: torch.Tensor, grid: GridComm,
                         axes: Sequence[str], algorithm: str = "auto"
                         ) -> torch.Tensor:
        """Personalized exchange over a tuple of the grid's axes through
        a joint topology plan (``lax.all_to_all(x, axes, 0, 0,
        tiled=True)`` semantics over the row-major-folded axes).

        ``algorithm`` is ``"auto"`` (planner argmin), a plan shape
        (``"hierarchical" | "sequential" | "flat" | "latency"`` or a
        ``*_pipelined`` variant), ``"lax"`` (the native over the folded
        axes), or a 1D backend name (``ring``/``halving``), which runs
        the innermost-first phase order with that backend on every
        axis."""
        axes = self._grid_axes(grid, axes)[0]
        if len(axes) == 1:
            # a plan shape collapses to the 1D selector on a bare axis
            if algorithm in planner.ALL_TO_ALL_SHAPES:
                algorithm = "auto"
            return self.all_to_all_inside(x, grid.sub(axes), algorithm)
        return self._traced(
            "all_to_all_multi", "all_to_all", grid, axes, self._nbytes(x),
            algorithm, lambda: self._all_to_all_multi(x, grid, axes,
                                                      algorithm))

    def _all_to_all_multi(self, x: torch.Tensor, grid: GridComm,
                          axes: Tuple[str, ...], algorithm: str
                          ) -> torch.Tensor:
        axes, sizes, p = self._grid_axes(grid, axes)
        self._check(x, grid)
        if algorithm == "lax":
            return grid.sub(axes).all_to_all(x)
        if p == 1:
            return x
        if x.shape[0] % p:
            raise ValueError(f"leading dim {x.shape[0]} is not divisible "
                             f"by the folded size {p}")
        nbytes = self._nbytes(x)
        if algorithm == "auto" or algorithm in planner.ALL_TO_ALL_SHAPES:
            shape = None if algorithm == "auto" else algorithm
            plan = self.plan_multi("all_to_all", axes, sizes, nbytes,
                                   shape=shape)
            if plan.shape in ("flat", "latency"):
                (step,) = plan.steps
                return self.all_to_all_inside(x, grid.sub(step.axes),
                                              step.algorithm)
            return self._run_a2a_phases(x, grid, axes, sizes, plan.steps,
                                        plan.n_chunks)
        steps = tuple(
            planner.PlanStep("all_to_all", (a,), algorithm, nbytes)
            for a, s in zip(reversed(axes), reversed(sizes)) if s > 1)
        return self._run_a2a_phases(x, grid, axes, sizes, steps)

    def _a2a_phase_fns(self, grid: GridComm, axes: Tuple[str, ...],
                       sizes: Tuple[int, ...],
                       steps: Sequence[planner.PlanStep]
                       ) -> List[Callable[[torch.Tensor], torch.Tensor]]:
        """Per-phase closures over the block grid.  Each views its
        input's leading dim as a ``sizes``-shaped grid of blocks and
        exchanges along block dim *i* only, turning that destination
        coordinate into the source coordinate in place."""
        k = len(sizes)
        p = math.prod(sizes)

        def make(step):
            i = axes.index(step.axes[0])
            perm = (i,) + tuple(j for j in range(k) if j != i)
            inv = tuple(perm.index(j) for j in range(k))
            comm = grid.sub(step.axes[0])

            def fn(v):
                m = v.shape[0] // p
                tail = tuple(v.shape[1:])
                blocks = v.reshape(tuple(sizes) + (m,) + tail)
                rest = tuple(range(k, blocks.dim()))
                t = blocks.permute(perm + rest)
                out = self.all_to_all_inside(t.reshape((-1,) + tail), comm,
                                             step.algorithm)
                return out.reshape(t.shape).permute(inv + rest).reshape(
                    v.shape)

            return fn

        return [make(step) for step in steps]

    def _run_a2a_phases(self, x: torch.Tensor, grid: GridComm,
                        axes: Tuple[str, ...], sizes: Tuple[int, ...],
                        steps: Sequence[planner.PlanStep],
                        n_chunks: int = 1) -> torch.Tensor:
        """Per-axis all-to-all phases over the block grid: after every
        effective axis has run once (any order), the block grid is
        source-major row-major, the folded tuple's ``all_to_all``.  With
        ``n_chunks > 1`` each block gives a row slice to each chunk and
        the phases run in wavefront order."""
        fns = self._a2a_phase_fns(grid, axes, sizes, steps)
        names = self._phase_names(steps)
        c = max(1, n_chunks)
        if c == 1:
            return self._run_phases([x], fns, op="all_to_all",
                                    phase_names=names)[0]
        p = math.prod(sizes)
        chunks, m = self._split_row_chunks(x, p, c)
        chunks = self._run_phases(chunks, fns, op="all_to_all",
                                  phase_names=names)
        return self._join_row_chunks(chunks, p, m)

    # ------------------------------------------------------------------ #
    # fused compute + collective: matmul feeding a ring reduce-scatter
    # ------------------------------------------------------------------ #
    def price_fused_matmul_rs(self, m: int, k: int, n: int, p: int,
                              axes: Any = None, dtype_bytes: int = 4
                              ) -> Dict[str, float]:
        """Model prices for the fused vs serialized matmul+RS.

        ``[m, k] @ [k, n]`` per rank, reduce-scattered over a P-way axis.
        ``fused`` is the overlap closed form with C = P chunks
        (``patterns.t_fused_matmul_rs``); ``serial`` is the full GEMM
        followed by the best cached reduce-scatter decision.  ``saved``
        > 0 is the model saying the block GEMMs hide the ring hops --
        the bit ``"auto"`` dispatch acts on."""
        if isinstance(axes, (tuple, list)):
            axes = tuple(axes)
        fab = self.topology.for_axis(axes)
        nbytes = int(m) * int(n) * int(dtype_bytes)
        t_mm = pat.t_matmul(m, k, n)
        fused = pat.t_fused_matmul_rs(p, self._elements(nbytes), t_mm,
                                      fab)
        rs = self.select("reduce_scatter", nbytes, p, fabric=fab)
        serial = t_mm + rs.predicted
        return {"fused": float(fused), "serial": float(serial),
                "saved": float(serial - fused), "t_mm": float(t_mm),
                "t_rs": float(rs.predicted)}

    def fused_matmul_reduce_scatter(self, x: torch.Tensor,
                                    w: Optional[torch.Tensor],
                                    comm: Union[Comm, GridComm],
                                    *, algorithm: str = "auto",
                                    axes: Any = None) -> torch.Tensor:
        """``reduce_scatter(x @ w)`` over the axis, with the block GEMMs
        between the ring's hops.

        ``x``: local ``[M, K_loc]``; ``w``: local ``[K_loc, N]`` (the
        contraction dim sharded over the axis); returns ``[M/P, N]`` with
        rank ``i`` holding row block ``i`` of the summed product
        (``lax.psum_scatter(..., tiled=True)`` semantics).

        ``algorithm``: ``"auto"`` runs the fused ring exactly when the
        model prices it below the serialized GEMM-then-RS
        (:meth:`price_fused_matmul_rs`); ``"fused"`` / ``"unfused"``
        force either path.  ``w=None`` (the FSDP grad-sync site, no
        local GEMM) is the engine's reduce-scatter.  M not divisible by
        P takes the gathered path, as in the reference.

        ``comm`` is one axis's communicator, or a grid with the ``axes``
        the reference names: several axes take the multi-axis
        reduce-scatter when ``w`` is None, and their folded sub-comm
        otherwise."""
        if isinstance(comm, GridComm):
            axes = self._grid_axes(comm, axes)[0]
            if w is None and len(axes) > 1:
                return self.reduce_scatter_multi(x, comm, axes, algorithm)
            comm = comm.sub(axes)
        if w is None:
            return self.reduce_scatter_inside(x, comm, algorithm)
        self._check(x, comm)
        p = comm.size
        m, k = x.shape
        n = w.shape[-1]
        price = self.price_fused_matmul_rs(
            m, k, n, p, axes=comm.axis, dtype_bytes=x.element_size())
        if algorithm == "fused":
            use_fused = True
        elif algorithm == "unfused":
            use_fused = False
        else:
            use_fused = price["saved"] > 0.0
        if m % max(p, 1) != 0:
            use_fused = False       # the ring cannot tile the rows

        def run() -> torch.Tensor:
            if use_fused:
                return impl.fused_matmul_rs(x, w, comm)
            return impl.matmul_then_rs(x, w, comm)

        # the span's decision is the model's fused-vs-serial price
        return self._traced(
            "fused_matmul_rs", "fused_matmul_rs", comm, None,
            m * n * x.element_size(), algorithm, run, decided=dict(
                algorithm="fused_ring" if use_fused else "unfused",
                algorithm_forced=algorithm != "auto", cache="model",
                predicted=price["fused" if use_fused else "serial"],
                overlap_saved=price["saved"]))

    # ------------------------------------------------------------------ #
    # outer wrappers.  The reference builds a shard_map over a mesh for
    # replicated (or sharded) global arrays; in the port every rank
    # already holds its local block, so each wrapper is its op run on
    # this rank of ``comm``.
    # ------------------------------------------------------------------ #
    def allreduce(self, x: torch.Tensor, comm: Comm,
                  algorithm: str = "auto") -> torch.Tensor:
        return self.allreduce_inside(x, comm, algorithm)

    def reduce_to_root(self, x: torch.Tensor, comm: Comm,
                       algorithm: str = "auto") -> torch.Tensor:
        return self.reduce_inside(x, comm, algorithm)

    def reduce_scatter(self, x: torch.Tensor, comm: Comm,
                       algorithm: str = "auto") -> torch.Tensor:
        """This rank's [N/P, ...] chunk of the sum of every rank's
        [N, ...] ``x``."""
        return self.reduce_scatter_inside(x, comm, algorithm)

    def allgather(self, x: torch.Tensor, comm: Comm,
                  algorithm: str = "auto") -> torch.Tensor:
        """Every rank's [N/P, ...] shard gathered into [N, ...]."""
        return self.allgather_inside(x, comm, algorithm)

    def broadcast(self, x: torch.Tensor, comm: Comm, root: int = 0,
                  algorithm: str = "auto") -> torch.Tensor:
        return self.broadcast_inside(x, comm, root, algorithm)

    def all_to_all(self, x: torch.Tensor, comm: Comm,
                   algorithm: str = "auto") -> torch.Tensor:
        """The distributed transpose of each rank's [N/P, ...] block."""
        return self.all_to_all_inside(x, comm, algorithm)


__all__ = ["CollectiveEngine", "Decision", "fit_fabric", "fit_launch",
           "measure_ppermute", "load_topology", "find_calibrated_topology",
           "topology_to_dict", "topology_from_dict", "fabric_to_dict",
           "SCHEMA_VERSION", "MODEL_VERSION", "ICI_ELEMENT_BYTES"]
