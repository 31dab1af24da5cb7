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
``(op, P, bytes, fabric)``.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): the planner and the multi-axis ops (``plan_multi``, ``*_multi``),
``calibrate`` / ``calibrate_launch`` / ``measure_ppermute`` on NVLink, and
spans (``obs/``): the port behaves as the reference does with tracing
off.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.collectives import shardmap_impl as impl
from repro_torch.collectives.comm import Comm
from repro_torch.core import patterns as pat
from repro_torch.core import selector
from repro_torch.core.autogen import autogen_tree, cache_dir, compute_tables
from repro_torch.core.model import (Fabric, FabricTopology, TPU_V5E_AXIS,
                                    as_topology)
from repro_torch.device import DeviceLike, resolve_device

#: one model "element" on the TPU fabric (512-byte flit group).  A TPU
#: figure, kept so that the port's decisions match the reference's.
ICI_ELEMENT_BYTES = 512

#: bump when the cost model changes (patterns/selector) so persisted
#: decisions computed under the old model stop being served (the
#: reference's value: the port prices with the same model).
MODEL_VERSION = 3

#: persisted-file layout version (the reference's v3 layout: decisions
#: keyed by topology signature, the fabric topology in a ``topology``
#: section; the ``plans`` section comes with the planner, ROADMAP A.2).
SCHEMA_VERSION = 3

Rounds = Tuple[Tuple[Tuple[int, int], ...], ...]

_NOT_PORTED = {
    "multi": "ROADMAP A.2: the planner and the multi-axis ops",
    "calibrate": "ROADMAP A.2: calibrate on NVLink with an H100 Fabric",
}


def _not_ported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported to repro_torch yet ({_NOT_PORTED[item]})")


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


def fit_fabric(*args, **kwargs) -> Fabric:
    raise _not_ported("fit_fabric", "calibrate")


def measure_ppermute(*args, **kwargs):
    raise _not_ported("measure_ppermute", "calibrate")


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

    Only *calibrated* topologies (named ``<base>_calibrated``) of
    ``base``'s family qualify, as in the reference."""
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
    """

    def __init__(self, fabric: "Fabric | FabricTopology" = TPU_V5E_AXIS,
                 cache_path: Optional[str] = None, persist: bool = True,
                 element_bytes: int = ICI_ELEMENT_BYTES,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.topology = as_topology(fabric)
        self.element_bytes = element_bytes
        self._persist = persist
        self._cache_path_override = cache_path
        self._decisions: Dict[str, Decision] = {}
        self._tree_rounds: Dict[Tuple[int, int, Fabric], Rounds] = {}
        self._tables: Dict[int, Any] = {}
        self._loaded = False
        self._lock = threading.RLock()
        self._dirty = False
        self._last_save = 0.0
        self.stats = {"hits": 0, "misses": 0, "dp_runs": 0,
                      "persisted_loads": 0, "latency_dispatches": 0}
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
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"schema": SCHEMA_VERSION,
                           "fabric": self._fabric_tag(),
                           "topology": topology_to_dict(self.topology),
                           "decisions": raw}, f)
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

    def clear_cache(self) -> None:
        with self._lock:
            self._decisions.clear()
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
    # not ported yet
    # ------------------------------------------------------------------ #
    def plan_multi(self, *args, **kwargs):
        raise _not_ported("plan_multi", "multi")

    def allreduce_multi(self, *args, **kwargs):
        raise _not_ported("allreduce_multi", "multi")

    def reduce_scatter_multi(self, *args, **kwargs):
        raise _not_ported("reduce_scatter_multi", "multi")

    def allgather_multi(self, *args, **kwargs):
        raise _not_ported("allgather_multi", "multi")

    def all_to_all_multi(self, *args, **kwargs):
        raise _not_ported("all_to_all_multi", "multi")

    def calibrate(self, *args, **kwargs):
        raise _not_ported("calibrate", "calibrate")

    def calibrate_launch(self, *args, **kwargs):
        raise _not_ported("calibrate_launch", "calibrate")

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
        if algorithm == "auto":
            d, _ = self._select_meta(op, nbytes, p, fabric=fab)
            if d.algorithm == "oneshot":
                with self._lock:
                    self.stats["latency_dispatches"] += 1
            return d.algorithm, d.rounds
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

    def reduce_inside(self, x: torch.Tensor, comm: Comm,
                      algorithm: str = "auto") -> torch.Tensor:
        """Paper Reduce: the full sum lands on rank 0 of the axis."""
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
        red = self.reduce_inside(x, comm, algorithm)
        return impl.broadcast(red, comm, root=0)

    def reduce_scatter_inside(self, x: torch.Tensor, comm: Comm,
                              algorithm: str = "auto") -> torch.Tensor:
        """Sum over the axis, shard the result: rank i gets chunk i
        (``lax.psum_scatter(..., tiled=True)`` semantics; leading dim
        divisible by P)."""
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
                                    w: Optional[torch.Tensor], comm: Comm,
                                    *, algorithm: str = "auto"
                                    ) -> torch.Tensor:
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
        P takes the gathered path, as in the reference."""
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
        if use_fused:
            return impl.fused_matmul_rs(x, w, comm)
        return impl.matmul_then_rs(x, w, comm)

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


__all__ = ["CollectiveEngine", "Decision", "fit_fabric",
           "measure_ppermute", "load_topology", "find_calibrated_topology",
           "topology_to_dict", "topology_from_dict", "fabric_to_dict",
           "SCHEMA_VERSION", "MODEL_VERSION", "ICI_ELEMENT_BYTES"]
