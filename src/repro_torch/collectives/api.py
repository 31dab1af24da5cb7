"""Public collective API: model-driven selection over one axis or a grid.

    allreduce(x, comm, algorithm="auto")
    reduce_scatter(x, comm, algorithm="auto")
    allgather(x, comm, algorithm="auto")
    broadcast(x, comm, root=0, algorithm="auto")
    all_to_all(x, comm, algorithm="auto")
    allreduce_multi_inside(x, grid, axes, algorithm="auto")   (and the
        reduce_scatter / allgather / all_to_all forms, plan_collective)

``comm`` is this rank's :class:`~repro_torch.collectives.comm.Comm` (the
port's counterpart of a mesh axis).  ``algorithm``:

  psum        -- the communicator's native all-reduce (the baseline)
  chain / tree / two_phase / star -- the paper's fixed patterns (Sec. 5)
                 composed with a doubling broadcast (Sec. 6.1)
  ring        -- reduce-scatter + all-gather (Sec. 6.2)
  autogen     -- the Auto-Gen DP tree executed as rounds of disjoint
                 ppermutes (Sec. 5.5)
  auto        -- the model (Eq. 1, the reference's TPU parameterization)
                 picks among the above given (bytes, axis size).

Dispatch and caching live in the CollectiveEngine (engine.py); this
module keeps the functional surface and hands out a process-wide
default engine per (fabric, device), so every call site shares one
decision cache.  The ``*_multi_inside`` entry points and
``plan_collective`` run the topology planner's joint plans over a tuple
of a :class:`~repro_torch.collectives.comm.GridComm`'s axes.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.collectives.comm import Comm, GridComm
from repro_torch.collectives.engine import (CollectiveEngine,
                                            find_calibrated_topology)
from repro_torch.core.model import TPU_V5E_AXIS, Fabric, FabricTopology
from repro_torch.device import DeviceLike, resolve_or_meta

_FabricKey = Union[Fabric, FabricTopology]
_ENGINES: Dict[Tuple[_FabricKey, str], CollectiveEngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(fabric: _FabricKey = TPU_V5E_AXIS,
               device: DeviceLike = None) -> CollectiveEngine:
    """Process-wide engine for a fabric (or fabric topology) on a device
    type (shared decision cache).  ``device`` defaults to CUDA and
    raises without a GPU; ``"meta"`` is the dry-run's.

    The first time the stock default fabric is requested, the port's
    cache directory is checked for a calibrated v3 ``FabricTopology``
    (``engine.find_calibrated_topology``); when one is found the engine
    is built on it, as in the reference.  ``REPRO_TORCH_RESTORE_TOPOLOGY=0``
    (the port's ``REPRO_RESTORE_TOPOLOGY``) opts out: the stock
    constants, whatever a calibration left in the cache.  An explicitly
    requested ``FabricTopology`` key is never overridden.  ``set_engine``
    installs another."""
    dev = resolve_or_meta(device)
    with _ENGINES_LOCK:
        key = (fabric, dev.type)
        eng = _ENGINES.get(key)
        if eng is None:
            build = fabric
            if isinstance(fabric, Fabric):
                restored = find_calibrated_topology(base=fabric)
                if restored is not None:
                    build = restored
            eng = CollectiveEngine(fabric=build, device=dev)
            _ENGINES[key] = eng
        return eng


def set_engine(engine: CollectiveEngine,
               fabric: Optional[_FabricKey] = None) -> None:
    """Install ``engine`` as the default for its (or ``fabric``'s) key
    on its device type."""
    with _ENGINES_LOCK:
        _ENGINES[(fabric or engine.fabric, engine.device.type)] = engine


def _engine(comm: Union[Comm, GridComm], fabric: _FabricKey
            ) -> CollectiveEngine:
    return get_engine(fabric, device=comm.device)


def select_algorithm(nbytes: int, p: int, fabric: Fabric = TPU_V5E_AXIS,
                     device: DeviceLike = None) -> str:
    """The paper's model-driven AllReduce selection (cached per
    (P, bytes) by the engine)."""
    return get_engine(fabric, device).select("allreduce", nbytes,
                                             p).algorithm


def allreduce_inside(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
                     fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    return _engine(comm, fabric).allreduce_inside(x, comm, algorithm)


def reduce_scatter_inside(x: torch.Tensor, comm: Comm,
                          algorithm: str = "auto",
                          fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    return _engine(comm, fabric).reduce_scatter_inside(x, comm, algorithm)


def allgather_inside(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
                     fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    return _engine(comm, fabric).allgather_inside(x, comm, algorithm)


def broadcast_inside(x: torch.Tensor, comm: Comm, root: int = 0,
                     algorithm: str = "auto",
                     fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    return _engine(comm, fabric).broadcast_inside(x, comm, root, algorithm)


def all_to_all_inside(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
                      fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    return _engine(comm, fabric).all_to_all_inside(x, comm, algorithm)


def allreduce(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
              fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """AllReduce this rank's ``x`` over the communicator's axis."""
    return _engine(comm, fabric).allreduce(x, comm, algorithm)


def reduce_to_root(x: torch.Tensor, comm: Comm, algorithm: str = "chain",
                   fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Paper Reduce: the result is valid on rank 0 of the axis."""
    return _engine(comm, fabric).reduce_to_root(x, comm, algorithm)


def reduce_scatter(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
                   fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Sum over the axis; rank i keeps chunk i of the leading dim."""
    return _engine(comm, fabric).reduce_scatter(x, comm, algorithm)


def allgather(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
              fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Gather every rank's leading-dim shard into one array."""
    return _engine(comm, fabric).allgather(x, comm, algorithm)


def broadcast(x: torch.Tensor, comm: Comm, root: int = 0,
              algorithm: str = "auto",
              fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Replicate rank ``root``'s value across the axis."""
    return _engine(comm, fabric).broadcast(x, comm, root, algorithm)


def all_to_all(x: torch.Tensor, comm: Comm, algorithm: str = "auto",
               fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Distributed transpose: each rank's block exchanged chunk for
    chunk with every peer."""
    return _engine(comm, fabric).all_to_all(x, comm, algorithm)


def allreduce_multi_inside(x: torch.Tensor, grid: GridComm, axes,
                           algorithm: str = "auto",
                           fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Joint multi-axis AllReduce (planner-driven) over a tuple of the
    grid's axes.  ``algorithm`` is ``"auto"`` or a plan shape:
    ``sequential`` / ``hierarchical`` / ``2d_xy`` / ``2d_snake`` /
    ``flat`` / ``latency`` (or a 1D backend name, run on every axis)."""
    return _engine(grid, fabric).allreduce_multi(x, grid, axes, algorithm)


def reduce_scatter_multi_inside(x: torch.Tensor, grid: GridComm, axes,
                                algorithm: str = "auto",
                                fabric: Fabric = TPU_V5E_AXIS
                                ) -> torch.Tensor:
    """Multi-axis reduce-scatter (``lax.psum_scatter(x, axes,
    tiled=True)`` semantics over the folded axes)."""
    return _engine(grid, fabric).reduce_scatter_multi(x, grid, axes,
                                                      algorithm)


def allgather_multi_inside(x: torch.Tensor, grid: GridComm, axes,
                           algorithm: str = "auto",
                           fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Multi-axis allgather (``lax.all_gather(x, axes, tiled=True)``
    semantics over the folded axes)."""
    return _engine(grid, fabric).allgather_multi(x, grid, axes, algorithm)


def all_to_all_multi_inside(x: torch.Tensor, grid: GridComm, axes,
                            algorithm: str = "auto",
                            fabric: Fabric = TPU_V5E_AXIS) -> torch.Tensor:
    """Joint multi-axis all_to_all (planner-driven).  ``algorithm`` is
    ``"auto"``, a plan shape (``hierarchical`` / ``sequential`` /
    ``flat`` / ``latency``), ``"lax"`` (the native over the folded
    axes) or a 1D backend name (``ring`` / ``halving``)."""
    return _engine(grid, fabric).all_to_all_multi(x, grid, axes, algorithm)


def plan_collective(op: str, grid: GridComm, axes, nbytes: int,
                    fabric: Fabric = TPU_V5E_AXIS):
    """The joint ``CollectivePlan`` the engine would run for an op over
    a tuple of the grid's axes at a given byte size (introspection)."""
    axes = tuple(axes)
    sizes = tuple(grid.axis_size(a) for a in axes)
    return _engine(grid, fabric).plan_multi(op, axes, sizes, nbytes)


__all__ = ["get_engine", "set_engine", "select_algorithm",
           "allreduce", "allreduce_inside", "allreduce_multi_inside",
           "reduce_scatter", "reduce_scatter_inside",
           "reduce_scatter_multi_inside",
           "allgather", "allgather_inside", "allgather_multi_inside",
           "broadcast", "broadcast_inside", "reduce_to_root",
           "all_to_all", "all_to_all_inside", "all_to_all_multi_inside",
           "plan_collective"]
