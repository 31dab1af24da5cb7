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

A ``Comm`` is made for CUDA unless the caller passes ``device="cpu"``;
without a GPU that raises (``repro_torch.device.resolve_device``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

Pairs = Sequence[Tuple[int, int]]

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


def _chunks(x: torch.Tensor, p: int) -> List[torch.Tensor]:
    if x.shape[0] % p:
        raise ValueError(f"leading dim {x.shape[0]} is not divisible by "
                         f"the axis size {p}")
    return list(x.reshape((p, x.shape[0] // p) + tuple(x.shape[1:]))
                .unbind(0))


class Comm:
    """One rank's handle on a group of ``size`` ranks along one axis.

    ``axis`` names the axis for a per-axis fabric lookup
    (``FabricTopology.for_axis``); None prices with the default fabric.
    """

    rank: int
    size: int
    device: torch.device
    axis: Optional[str]

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
    """What the threads of one :func:`run_local` share: a barrier and
    one slot per rank for the tensor it offers in the current round."""

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


class LocalComm(Comm):
    """Rank ``rank`` of ``size`` threads of one process on one device.

    Each round is a barrier, a hand-off of tensors and a device copy
    (``clone``), then a second barrier.  Every rank thread launches on
    PyTorch's legacy default stream (a thread that never set a stream
    uses it), so the copy a receiver enqueues runs after the kernels the
    sender enqueued to produce the tensor, and before anything the
    sender enqueues after the round: no event or stream synchronisation
    is needed.  Made by :func:`run_local`.
    """

    def __init__(self, group: _LocalGroup, rank: int, device: torch.device,
                 axis: Optional[str] = None):
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
        """Sum over ranks in rank order, in the input dtype."""
        self._check(x)
        slots = self._group.offer(self.rank, x)
        out = slots[0].clone()
        for other in slots[1:]:
            out = out + other
        self._group.done()
        return out

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        slots = self._group.offer(self.rank, x)
        parts = [_chunks(t, self.size)[self.rank] for t in slots]
        out = parts[0].clone()
        for other in parts[1:]:
            out = out + other
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


def run_local(fn: Callable[[LocalComm], Any], size: int,
              device: DeviceLike = None, *, axis: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT) -> List[Any]:
    """Run ``fn(comm)`` on ``size`` :class:`LocalComm` ranks, one thread
    each, and return their results by rank.  ``device`` defaults to
    CUDA (and raises without a GPU).  If a rank raises, the others are
    released from their barriers and the first error is raised here."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if size < 1:
        raise ValueError(f"need at least one rank, got {size}")
    group = _LocalGroup(size, timeout)
    results: List[Any] = [None] * size
    errors: Dict[int, BaseException] = {}

    def worker(rank: int) -> None:
        try:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            results[rank] = fn(LocalComm(group, rank, dev, axis))
        except BaseException as exc:        # noqa: BLE001 -- re-raised
            errors[rank] = exc
            group.barrier.abort()

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


# ---------------------------------------------------------------------- #
# one process per rank, over torch.distributed
# ---------------------------------------------------------------------- #
class ProcessGroupComm(Comm):
    """This process's rank of a ``torch.distributed`` process group.

    Each ``ppermute`` round is one ``dist.batch_isend_irecv`` of the
    rank's own sends and receive.  The group must be initialised
    (``dist.init_process_group``); on CUDA pass this rank's card as
    ``device`` (``"cuda:<local rank>"``).  The constructor makes it the
    current device and runs one all-reduce over the whole group: NCCL
    wants the first ``batch_isend_irecv`` of a group to involve every
    rank, which a round of a reduce schedule does not.
    """

    def __init__(self, group: Optional[dist.ProcessGroup] = None,
                 device: DeviceLike = None, axis: Optional[str] = None):
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs "
                               "torch.distributed.init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = dev
        self.axis = axis
        warm = torch.zeros(1, device=dev)
        dist.all_reduce(warm, group=group)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _peer(self, rank: int) -> int:
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

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
        parts = _chunks(x.contiguous(), self.size)
        out = torch.empty_like(parts[0])
        dist.reduce_scatter_tensor(out, x.contiguous(), group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * self.size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        x = x.contiguous()
        _chunks(x, self.size)               # checks divisibility
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out


__all__ = ["Comm", "LocalComm", "ProcessGroupComm", "run_local",
           "DEFAULT_TIMEOUT"]
