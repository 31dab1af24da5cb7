"""Communicators: the port's counterpart of one ``shard_map`` mesh axis.

Under ``shard_map`` every device runs the same program and talks to its
peers along a named axis through ``lax.ppermute`` and the native
collectives (``psum``, ``psum_scatter``, ``all_gather``,
``all_to_all``).  In the port every rank runs the same Python function
and talks to its peers through a :class:`Comm`:

* ``rank`` / ``size``: the axis index and the axis size;
* ``ppermute(x, pairs)``: one round of disjoint ``(src, dst)`` sends; a
  rank that receives nothing gets zeros, exactly as ``lax.ppermute``
  gives;
* ``psum``, ``psum_scatter``, ``all_gather``, ``all_to_all``: the
  natives, with ``tiled=True`` semantics along the leading dim.

Two backends:

* :class:`LocalComm` runs P ranks as P threads of one process on one
  device (the counterpart of ``--xla_force_host_platform_device_count``);
  :func:`run_local` starts them and returns the per-rank results.  This
  is how P ranks run on one card, where NCCL refuses two ranks per GPU.
* :class:`ProcessGroupComm` runs over ``torch.distributed``: one process
  per rank, NCCL on cards and gloo on the CPU.

The dry-run's :class:`CountingGridComm` is one rank of a grid on the
meta device: every native returns the shape it would, and a
:class:`CollectiveCounter` records calls and bytes.

A ``Comm`` is made for CUDA unless the caller passes ``device="cpu"``;
without a GPU that raises (``repro_torch.device.resolve_device``).
"""

from __future__ import annotations

import copy
import itertools
import math
import threading
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                   Union)

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

Pairs = Sequence[Tuple[int, int]]
#: one axis name, or a tuple of names for a folded (row-major) subset
AxisName = Union[str, Tuple[str, ...], None]

#: seconds a LocalComm rank waits for its peers before it gives up
DEFAULT_TIMEOUT = 600.0


def _recv_source(pairs: Pairs, rank: int, size: int) -> Optional[int]:
    """The rank that sends to ``rank`` in this round (None: nobody).
    Checks that the round is a valid ``ppermute``: sources and
    destinations in range and each used at most once."""
    srcs, dsts = set(), set()
    found = None
    for s, d in pairs:
        s, d = int(s), int(d)
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"ppermute pair {(s, d)} outside axis size "
                             f"{size}")
        if s in srcs or d in dsts:
            raise ValueError(f"ppermute pairs {list(pairs)} are not "
                             f"disjoint")
        srcs.add(s)
        dsts.add(d)
        if d == rank:
            found = s
    return found


def _rank_order_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The natives' sum, as XLA's CPU all-reduce adds under
    ``shard_map``: in rank order, a 16-bit float type accumulated in
    float32 and rounded once (float32 in float32)."""
    acc = parts[0].clone()
    if acc.dtype in (torch.bfloat16, torch.float16):
        acc = acc.float()
    for other in parts[1:]:
        acc = acc + other
    return acc.to(parts[0].dtype)


def _chunks(x: torch.Tensor, p: int) -> List[torch.Tensor]:
    if x.shape[0] % p:
        raise ValueError(f"leading dim {x.shape[0]} is not divisible by "
                         f"the axis size {p}")
    return list(x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:]))
                .unbind(0))


class Comm:
    """One rank's handle on a group of ``size`` ranks along one axis.

    ``axis`` names the axis, or the tuple of axes a grid's folded subset
    spans, for a per-axis fabric lookup (``FabricTopology.for_axis``);
    None prices with the default fabric.  A comm cut from a grid
    (:meth:`GridComm.sub`) also knows the sizes of those axes
    (``axis_sizes``) and this rank's rank in the grid (``grid_rank``),
    which the engine's spans record; a bare comm leaves both None.
    """

    rank: int
    size: int
    device: torch.device
    axis: AxisName
    axis_sizes: Optional[Tuple[int, ...]] = None
    grid_rank: Optional[int] = None

    def _check(self, x: torch.Tensor) -> None:
        if x.device.type != self.device.type:
            raise ValueError(f"{type(self).__name__} on {self.device} got a "
                             f"tensor on {x.device}")

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


# ---------------------------------------------------------------------- #
# P ranks as P threads of one process
# ---------------------------------------------------------------------- #
class _LocalGroup:
    """What the rank threads of one group share: a barrier and one slot
    per rank for the tensor it offers in the current round."""

    def __init__(self, size: int, timeout: float):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: List[Optional[torch.Tensor]] = [None] * size

    def offer(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Publish ``x`` and wait until every rank has published."""
        self.slots[rank] = x
        self.barrier.wait()
        return self.slots        # read only until ``done``

    def done(self) -> None:
        """Wait until every rank has read (and enqueued its copies of)
        the slots, so that the next round may overwrite them."""
        self.barrier.wait()


class _LocalGroups:
    """Every :class:`_LocalGroup` of one run, made on first use by
    whichever rank asks first.  An error in any rank aborts every
    group's barrier, those made later included, so no rank waits on a
    peer that will never come (a grid's rows, columns and folded subsets
    are separate groups)."""

    def __init__(self, timeout: float):
        self._timeout = timeout
        self._lock = threading.Lock()
        self._groups: Dict[Any, _LocalGroup] = {}
        self._aborted = False

    def get(self, key: Any, size: int) -> _LocalGroup:
        with self._lock:
            group = self._groups.get(key)
            if group is None:
                group = _LocalGroup(size, self._timeout)
                if self._aborted:
                    group.barrier.abort()
                self._groups[key] = group
            return group

    def abort(self) -> None:
        with self._lock:
            self._aborted = True
            for group in self._groups.values():
                group.barrier.abort()


class LocalComm(Comm):
    """Rank ``rank`` of ``size`` threads of one process on one device.

    Each round is a barrier, a hand-off of tensors and a device copy
    (``clone``), then a second barrier.  Every rank thread launches on
    PyTorch's legacy default stream (a thread that never set a stream
    uses it), so the copy a receiver enqueues runs after the kernels the
    sender enqueued to produce the tensor, and before anything the
    sender enqueues after the round: no event or stream synchronisation
    is needed.  Made by :func:`run_local` and :meth:`GridComm.sub`.
    """

    def __init__(self, group: _LocalGroup, rank: int, device: torch.device,
                 axis: AxisName = None):
        self._group = group
        self.rank = rank
        self.size = group.size
        self.device = device
        self.axis = axis

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        self._check(x)
        src = _recv_source(pairs, self.rank, self.size)
        slots = self._group.offer(self.rank, x)
        out = (slots[src].clone() if src is not None
               else torch.zeros_like(x))
        self._group.done()
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks in rank order (:func:`_rank_order_sum`)."""
        self._check(x)
        slots = self._group.offer(self.rank, x)
        out = _rank_order_sum(slots)
        self._group.done()
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        slots = self._group.offer(self.rank, x)
        out = _rank_order_sum([_chunks(t, self.size)[self.rank]
                               for t in slots])
        self._group.done()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        slots = self._group.offer(self.rank, x)
        out = torch.cat(slots, dim=0)
        self._group.done()
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        slots = self._group.offer(self.rank, x)
        out = torch.cat([_chunks(t, self.size)[self.rank] for t in slots],
                        dim=0)
        self._group.done()
        return out


def _local_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _run_threads(fn: Callable[[int], Any], size: int, dev: torch.device,
                 groups: _LocalGroups) -> List[Any]:
    """``fn(rank)`` on ``size`` threads; the results by rank.  If a rank
    raises, every group of the run is aborted and the first error that
    is not a broken barrier is raised here."""
    results: List[Any] = [None] * size
    errors: Dict[int, BaseException] = {}

    def worker(rank: int) -> None:
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[rank] = fn(rank)
        except BaseException as exc:        # noqa: BLE001 -- re-raised
            errors[rank] = exc
            groups.abort()

    threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                name=f"local-rank-{r}")
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = [e for e in errors.values()
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or list(errors.values()))[0]
    return results


def run_local(fn: Callable[[LocalComm], Any], size: int,
              device: DeviceLike = None, *, axis: AxisName = None,
              timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(comm)`` on ``size`` :class:`LocalComm` ranks, one thread
    each, and return their results by rank.  ``device`` defaults to
    CUDA (and raises without a GPU).  If a rank raises, the others are
    released from their barriers and the first error is raised here."""
    dev = _local_device(device)
    if size < 1:
        raise ValueError(f"need at least one rank, got {size}")
    groups = _LocalGroups(timeout)
    group = groups.get((), size)
    return _run_threads(lambda r: fn(LocalComm(group, r, dev, axis)),
                        size, dev, groups)


# ---------------------------------------------------------------------- #
# a grid of ranks: the counterpart of a multi-axis mesh
# ---------------------------------------------------------------------- #
class GridComm:
    """This rank's handle on an ``m0 x m1 x ...`` grid of ranks with
    named axes, the port's counterpart of a ``shard_map`` mesh.

    Global ranks are row-major over ``shape``.  :meth:`sub` gives the
    :class:`Comm` over the ranks that share this rank's coordinates on
    every axis not named: ``sub("data")`` is this rank's row along
    ``data``, ``sub(("pod", "data"))`` the folded subset, its ranks
    numbered row-major over the axes *in the order given* (the
    reference's ``_axis_index`` of a tuple), so ``("pod", "data")`` and
    ``("data", "pod")`` are two rank orders of one set.  The sub-comm's
    ``axis`` is the name, or the tuple of names, that
    ``FabricTopology.for_axis`` prices.  Made by :func:`run_local_grid`
    (threads) and :class:`ProcessGroupGrid` (``torch.distributed``).
    """

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int
    device: torch.device

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int, device: torch.device):
        self.axis_names = tuple(str(a) for a in axis_names)
        self.shape = tuple(int(s) for s in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} vs shape "
                             f"{self.shape}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"grid shape {self.shape} has an empty axis")
        self.size = math.prod(self.shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a grid of {self.size}")
        self.rank = rank
        self.device = device
        self._subs: Dict[Tuple[str, ...], Comm] = {}

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's coordinate on each axis."""
        return _unravel(self.rank, self.shape)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate on axis ``name``."""
        return self.coords[self._position(name)]

    def axis_size(self, name: str) -> int:
        return self.shape[self._position(name)]

    def axes_index(self, axes: Sequence[str]) -> int:
        """This rank's index over ``axes``, row-major in the order given
        (its rank in ``sub(axes)``, without making the sub-comm)."""
        index = 0
        for name in ((axes,) if isinstance(axes, str) else axes):
            index = index * self.axis_size(name) + self.axis_index(name)
        return index

    def _position(self, name: str) -> int:
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise ValueError(f"no axis {name!r} in grid "
                             f"{self.axis_names}") from None

    def members(self, axes: Sequence[str]) -> List[int]:
        """Global ranks of this rank's sub-group over ``axes``, in the
        sub-comm's rank order (row-major over ``axes`` as given)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [self._position(a) for a in axes]
        if len(set(pos)) != len(pos):
            raise ValueError(f"repeated axis in {tuple(axes)}")
        return _members(self.shape, self.coords, pos)

    def sub(self, axes: Union[str, Sequence[str]]) -> Comm:
        """The :class:`Comm` over ``axes`` (one name or a tuple)."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if not key:
            raise ValueError("sub() needs at least one axis")
        comm = self._subs.get(key)
        if comm is None:
            members = self.members(key)
            axis = key[0] if len(key) == 1 else key
            comm = self._make_sub(members, members.index(self.rank), axis)
            comm.axis_sizes = tuple(self.axis_size(a) for a in key)
            comm.grid_rank = self.rank
            self._subs[key] = comm
        return comm

    def _make_sub(self, members: List[int], sub_rank: int,
                  axis: AxisName) -> Comm:
        raise NotImplementedError


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    coords = []
    for s in reversed(shape):
        rank, c = divmod(rank, s)
        coords.append(c)
    return tuple(reversed(coords))


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    rank = 0
    for c, s in zip(coords, shape):
        rank = rank * s + c
    return rank


def _members(shape: Sequence[int], coords: Sequence[int],
             pos: Sequence[int]) -> List[int]:
    """Global ranks that share ``coords`` off the axes at ``pos``,
    row-major over those axes in the order given."""
    coords = list(coords)
    out = []
    for sub in itertools.product(*(range(shape[i]) for i in pos)):
        for i, c in zip(pos, sub):
            coords[i] = c
        out.append(_ravel(coords, shape))
    return out


class LocalGridComm(GridComm):
    """One thread's rank of a :func:`run_local_grid` grid: every
    sub-group is a :class:`_LocalGroup` of the run, keyed by its members
    in rank order."""

    def __init__(self, groups: _LocalGroups, axis_names: Sequence[str],
                 shape: Sequence[int], rank: int, device: torch.device):
        super().__init__(axis_names, shape, rank, device)
        self._groups = groups

    def _make_sub(self, members, sub_rank, axis) -> Comm:
        group = self._groups.get(tuple(members), len(members))
        return LocalComm(group, sub_rank, self.device, axis)


def run_local_grid(fn: Callable[[GridComm], Any], shape: Sequence[int],
                   names: Sequence[str], device: DeviceLike = None, *,
                   timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(grid)`` on every rank of a ``shape`` grid with axes
    ``names``, one thread a rank on one device, and return the results
    by global (row-major) rank.  ``device`` defaults to CUDA (and raises
    without a GPU).  If a rank raises, every row, column and folded
    subset of the grid is released and the first error is raised
    here."""
    dev = _local_device(device)
    size = math.prod(int(s) for s in shape)
    if size < 1:
        raise ValueError(f"grid shape {tuple(shape)} has no rank")
    groups = _LocalGroups(timeout)
    return _run_threads(
        lambda r: fn(LocalGridComm(groups, names, shape, r, dev)), size, dev,
        groups)


def single_rank_grid(names: Sequence[str], device: DeviceLike = None
                     ) -> GridComm:
    """The grid of a process with no peers: one rank, every axis of size
    1 (``device`` defaults to CUDA and raises without a GPU)."""
    return LocalGridComm(_LocalGroups(DEFAULT_TIMEOUT), names,
                         (1,) * len(names), 0, _local_device(device))


# ---------------------------------------------------------------------- #
# one process per rank, over torch.distributed
# ---------------------------------------------------------------------- #
def _process_device(device: DeviceLike) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        raise RuntimeError("ProcessGroupComm needs "
                           "torch.distributed.init_process_group first")
    return dev


class ProcessGroupComm(Comm):
    """This process's rank of a ``torch.distributed`` process group.

    Each ``ppermute`` round is one ``dist.batch_isend_irecv`` of the
    rank's own sends and receive.  The group must be initialised
    (``dist.init_process_group``); on CUDA pass this rank's card as
    ``device`` (``"cuda:<local rank>"``).  The constructor makes it the
    current device and runs one all-reduce over the whole group: NCCL
    wants the first ``batch_isend_irecv`` of a group to involve every
    rank, which a round of a reduce schedule does not.

    The comm's ranks are the group's, unless :meth:`reordered` numbers
    them otherwise (a grid's folded subset over axes in another order
    than the grid's); the natives then permute their chunks so that
    their results are in the comm's rank order.
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 device: DeviceLike = None, axis: AxisName = None):
        dev = _process_device(device)
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = dev
        self.axis = axis
        #: group rank of each comm rank (None: the group's own order)
        self._order: Optional[List[int]] = None
        warm = torch.zeros(1, device=dev)
        dist.all_reduce(warm, group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def reordered(self, order: Sequence[int], axis: AxisName
                  ) -> "ProcessGroupComm":
        """The same (warm) group with comm rank ``i`` on group rank
        ``order[i]``."""
        order = [int(g) for g in order]
        if sorted(order) != list(range(self.size)):
            raise ValueError(f"{order} is not an order of {self.size} ranks")
        out = copy.copy(self)
        out.axis = axis
        out._order = None if order == sorted(order) else order
        out.rank = order.index(dist.get_rank(self.group))
        return out

    def _group_rank(self, rank: int) -> int:
        return rank if self._order is None else self._order[rank]

    def _to_group_order(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Chunks in comm rank order, laid out in group rank order."""
        if self._order is None:
            return torch.cat(parts, dim=0)
        by_group: List[Optional[torch.Tensor]] = [None] * self.size
        for r, part in enumerate(parts):
            by_group[self._order[r]] = part
        return torch.cat(by_group, dim=0)

    def _from_group_order(self, x: torch.Tensor) -> torch.Tensor:
        """Chunks in group rank order, laid out in comm rank order."""
        if self._order is None:
            return x
        parts = _chunks(x, self.size)
        return torch.cat([parts[g] for g in self._order], dim=0)

    def _peer(self, rank: int) -> int:
        g = self._group_rank(rank)
        if self.group is None:
            return g
        return dist.get_global_rank(self.group, g)

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        self._check(x)
        src = _recv_source(pairs, self.rank, self.size)
        x = x.contiguous()
        p2p = []
        out = None
        for s, d in pairs:
            if int(s) == self.rank and int(d) != self.rank:
                p2p.append(dist.P2POp(dist.isend, x, self._peer(int(d)),
                                      self.group))
        if src == self.rank:
            out = x.clone()
        elif src is not None:
            out = torch.empty_like(x)
            p2p.append(dist.P2POp(dist.irecv, out, self._peer(src),
                                  self.group))
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        return out if out is not None else torch.zeros_like(x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = self._to_group_order(_chunks(x.contiguous(), self.size))
        out = torch.empty_like(_chunks(x, self.size)[0])
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * self.size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return self._from_group_order(out)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = self._to_group_order(_chunks(x.contiguous(), self.size))
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return self._from_group_order(out)


class ProcessGroupGrid(GridComm):
    """This process's rank of a grid over ``torch.distributed``: one
    process a rank, global rank ``dist.get_rank()`` row-major over
    ``shape`` (the world size must be the grid's).

    ``dist.new_group`` must be called by every process, for every
    sub-group, in the same order, members or not.  The constructor does
    that once for every subset of axes (in the grid's axis order) and
    every sub-group of each, then warms this process's group of each
    subset (one all-reduce, see :class:`ProcessGroupComm`), so a grid of
    k axes makes ``sum over subsets of (grid size / subset size)``
    groups.  :meth:`sub` over axes in another order reuses the subset's
    group with its ranks renumbered.
    """

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 device: DeviceLike = None):
        dev = _process_device(device)
        world = dist.get_world_size()
        super().__init__(names, shape, dist.get_rank(), dev)
        if world != self.size:
            raise ValueError(f"a {self.shape} grid needs {self.size} "
                             f"processes, the world has {world}")
        self._bases: Dict[Tuple[int, ...], ProcessGroupComm] = {}
        n = len(self.shape)
        for k in range(1, n + 1):
            for pos in itertools.combinations(range(n), k):
                others = [i for i in range(n) if i not in pos]
                mine = None
                for oc in itertools.product(*(range(self.shape[i])
                                              for i in others)):
                    coords = [0] * n
                    for i, c in zip(others, oc):
                        coords[i] = c
                    members = sorted(_members(self.shape, coords, pos))
                    group = dist.new_group(members)
                    if self.rank in members:
                        mine = (tuple(members), group)
                names_k = tuple(self.axis_names[i] for i in pos)
                axis = names_k[0] if k == 1 else names_k
                self._bases[mine[0]] = ProcessGroupComm(mine[1], dev, axis)

    def _make_sub(self, members, sub_rank, axis) -> Comm:
        ordered = tuple(sorted(members))
        # new_group numbers a group's ranks in ascending global order
        return self._bases[ordered].reordered(
            [ordered.index(m) for m in members], axis)


# ---------------------------------------------------------------------- #
# a counting grid: the dry-run's communicator
# ---------------------------------------------------------------------- #
#: each native's name in a compiled module's HLO
#: (``launch.roofline.COLLECTIVE_OPS``)
HLO_OPS = {"ppermute": "collective-permute", "psum": "all-reduce",
           "psum_scatter": "reduce-scatter", "all_gather": "all-gather",
           "all_to_all": "all-to-all"}


def _axis_label(axis: AxisName) -> str:
    if axis is None:
        return ""
    return axis if isinstance(axis, str) else ",".join(axis)


class CollectiveCounter:
    """Calls and bytes of the natives one rank's comms ran, by HLO op
    name and by axis (a folded subset's names joined by commas).  A
    call's bytes are its result's, as ``launch.roofline.
    parse_collective_bytes`` counts a compiled module's result shapes, so
    :meth:`ops` is what ``collective_total`` and ``roofline_terms``
    take."""

    def __init__(self):
        self._lock = threading.Lock()
        self.by_axis: Dict[str, Dict[str, Dict[str, float]]] = {}

    def add(self, native: str, axis: AxisName, nbytes: int) -> None:
        with self._lock:
            ops = self.by_axis.setdefault(_axis_label(axis), {})
            slot = ops.setdefault(HLO_OPS[native], {"bytes": 0.0,
                                                    "count": 0})
            slot["bytes"] += float(nbytes)
            slot["count"] += 1

    def ops(self) -> Dict[str, Dict[str, float]]:
        """{HLO op: {"bytes", "count"}} over every axis, every op keyed."""
        out = {op: {"bytes": 0.0, "count": 0} for op in HLO_OPS.values()}
        with self._lock:
            for ops in self.by_axis.values():
                for op, slot in ops.items():
                    out[op]["bytes"] += slot["bytes"]
                    out[op]["count"] += slot["count"]
        return out


class CountingComm(Comm):
    """A comm that records every native it runs in a
    :class:`CollectiveCounter`.  Around another comm (``inner``) it runs
    that comm's natives; alone it is a meta comm: each native returns a
    meta tensor of the shape and dtype :class:`LocalComm` returns, after
    the same checks of its arguments."""

    def __init__(self, counter: CollectiveCounter, rank: int, size: int,
                 device: torch.device, axis: AxisName = None,
                 inner: Optional[Comm] = None):
        self.counter = counter
        self.rank, self.size = rank, size
        self.device, self.axis = device, axis
        self.inner = inner

    def _run(self, native: str, x: torch.Tensor, shape, *args
             ) -> torch.Tensor:
        self._check(x)
        if self.inner is not None:
            out = getattr(self.inner, native)(x, *args)
        else:
            out = x.new_empty(shape)
        self.counter.add(native, self.axis, out.numel() * out.element_size())
        return out

    def ppermute(self, x: torch.Tensor, pairs: Pairs) -> torch.Tensor:
        _recv_source(pairs, self.rank, self.size)
        return self._run("ppermute", x, x.shape, pairs)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("psum", x, x.shape)

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("psum_scatter", x,
                         _chunks(x, self.size)[0].shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._run("all_gather", x,
                         (x.shape[0] * self.size,) + tuple(x.shape[1:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        _chunks(x, self.size)
        return self._run("all_to_all", x, x.shape)


class CountingGridComm(GridComm):
    """A grid whose every sub-comm is a :class:`CountingComm` on one
    :class:`CollectiveCounter` (``counter``).  Built from a shape it is
    one rank of a meta grid (no peers, nothing allocated: the dry-run
    sizes one rank's step of a production grid so); :meth:`around`
    counts what another grid's rank runs (a test holds the two counts
    equal)."""

    def __init__(self, shape: Sequence[int], names: Sequence[str],
                 rank: int = 0, *, inner: Optional[GridComm] = None):
        device = torch.device("meta") if inner is None else inner.device
        super().__init__(names, shape, rank, device)
        self.inner = inner
        self.counter = CollectiveCounter()

    @classmethod
    def around(cls, grid: GridComm) -> "CountingGridComm":
        """This rank of ``grid``, counted."""
        return cls(grid.shape, grid.axis_names, grid.rank, inner=grid)

    def _make_sub(self, members, sub_rank, axis) -> Comm:
        key = (axis,) if isinstance(axis, str) else tuple(axis)
        inner = None if self.inner is None else self.inner.sub(key)
        return CountingComm(self.counter, sub_rank, len(members),
                            self.device, axis, inner)


__all__ = ["Comm", "LocalComm", "ProcessGroupComm", "GridComm",
           "CollectiveCounter", "CountingComm", "CountingGridComm",
           "HLO_OPS", "LocalGridComm", "ProcessGroupGrid", "run_local",
           "run_local_grid", "single_rank_grid", "DEFAULT_TIMEOUT"]
