"""The grids the port runs on (counterpart of ``repro/launch/mesh.py``).

The reference models a TPU v5e pod as a 16 x 16 = 256-chip ("data",
"model") mesh, and the multi-pod deployment adds a leading "pod" axis
(2 x 16 x 16 = 512 chips); its debug meshes are (2, 4) and (2, 2, 2) on 8
virtual CPU devices.  Here a grid is its (shape, axis names), and the
helpers build it as ranks: ``local_grid`` runs a function on every rank
as a thread of this process (``run_local_grid``), ``process_grid`` gives
this process's rank of the grid over ``torch.distributed``
(``ProcessGroupGrid``; the world size must be the grid's).  Nothing here
touches a device until a grid is built.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.collectives.comm import (GridComm, ProcessGroupGrid,
                                          run_local_grid)
from repro_torch.device import DeviceLike

Grid = Tuple[Tuple[int, ...], Tuple[str, ...]]


def production_grid(*, multi_pod: bool = False) -> Grid:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model")."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def debug_grid(*, multi_pod: bool = False) -> Grid:
    """The small grids of the CPU tests: (2, 4) over ("data", "model"),
    or (2, 2, 2) over ("pod", "data", "model")."""
    if multi_pod:
        return (2, 2, 2), ("pod", "data", "model")
    return (2, 4), ("data", "model")


def local_grid(fn: Callable[[GridComm], Any], grid: Grid,
               device: DeviceLike = None) -> List[Any]:
    """``fn(rank's grid)`` on every rank of ``grid``, one thread a rank
    on one device (default CUDA); the results by global rank."""
    shape, names = grid
    return run_local_grid(fn, shape, names, device)


def process_grid(grid: Grid, device: DeviceLike = None) -> GridComm:
    """This process's rank of ``grid`` (after
    ``torch.distributed.init_process_group``)."""
    shape, names = grid
    return ProcessGroupGrid(shape, names, device=device)


__all__ = ["Grid", "debug_grid", "local_grid", "process_grid",
           "production_grid"]
