"""One fleet member: a ``ContinuousBatchingServer`` plus the cheap
load signal the router scores it by.

``load_signal()`` is pure host-side bookkeeping over state the server
already maintains (scheduler queue/slots, block allocator counters,
telemetry sample lists) -- no new per-step work is added to the serving
loop.  The TTFT EWMA folds in only the samples recorded since the last
call, so repeated polling stays O(new samples).

``predicted_cached_tokens()`` probes the replica's prefix cache with
the request's hash-chain keys *without* taking references: it is the
router's estimate of how much prefill compute this replica would skip,
not a reservation (the blocks can still be evicted before admission).

The port's copy of ``repro/serving/fleet/replica.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.scheduler import PREFILLING, Request
from repro_torch.serving.server import ContinuousBatchingServer, StepOutcome

#: EWMA weight of a new TTFT sample (~ last 10 samples dominate).
TTFT_EWMA_ALPHA = 0.2


@dataclasses.dataclass(frozen=True)
class LoadSignal:
    """Point-in-time routing view of one replica (all cheap reads)."""
    replica: int
    queue_depth: int                # requests waiting for a slot
    active: int                     # requests holding a slot
    running: int                    # rows decoding this wave
    queued_prefill_tokens: int      # prompt tokens waiting in the queue
    inflight_prefill_tokens: int    # admitted but not yet prefilled
    kv_blocks_live: int             # refcount >= 1 (true load)
    kv_blocks_evictable: int        # refcount-0 cached (reclaimable)
    kv_blocks_free: int
    ttft_ewma_s: Optional[float]    # None until a first token lands
    queue_wait_p50_ms: Optional[float]

    @property
    def pending_prefill_tokens(self) -> int:
        """Prefill compute already committed to this replica."""
        return self.queued_prefill_tokens + self.inflight_prefill_tokens

    @property
    def backlog(self) -> int:
        """Requests this replica owes work to (queued + active)."""
        return self.queue_depth + self.active


class Replica:
    """Wraps one ``ContinuousBatchingServer`` for fleet membership."""

    def __init__(self, index: int, server: ContinuousBatchingServer):
        self.index = index
        self.server = server
        self._ttft_ewma: Optional[float] = None
        self._ttft_seen = 0

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        self.server.submit(req)

    def has_work(self) -> bool:
        return self.server.has_work()

    def step(self) -> StepOutcome:
        return self.server.step_once()

    def results(self) -> Dict[int, List[int]]:
        """Drain-time partials (mirrors the tail of ``server.run``)."""
        out: Dict[int, List[int]] = {}
        for req in self.server.scheduler.retire_finished():
            out[req.rid] = req.out
        for _, req in self.server.scheduler.active():
            out.setdefault(req.rid, req.out)
        for req in self.server.scheduler.queue:
            out.setdefault(req.rid, req.out)
        return out

    # ------------------------------------------------------------------ #
    def _fold_ttft(self) -> Optional[float]:
        samples = self.server.telemetry.ttft_s
        for x in samples[self._ttft_seen:]:
            self._ttft_ewma = (x if self._ttft_ewma is None else
                               (1 - TTFT_EWMA_ALPHA) * self._ttft_ewma
                               + TTFT_EWMA_ALPHA * x)
        self._ttft_seen = len(samples)
        return self._ttft_ewma

    def load_signal(self) -> LoadSignal:
        sched = self.server.scheduler
        alloc = self.server.allocator
        tel = self.server.telemetry
        active = sched.active()
        inflight = sum(
            len(r.replay_tokens) - r.prefilled
            for _, r in active if r.state == PREFILLING)
        qwait = tel.queue_wait_s
        return LoadSignal(
            replica=self.index,
            queue_depth=len(sched.queue),
            active=len(active),
            running=len(sched.running()),
            queued_prefill_tokens=sum(
                len(r.replay_tokens) for r in sched.queue),
            inflight_prefill_tokens=inflight,
            kv_blocks_live=alloc.num_used,
            kv_blocks_evictable=alloc.num_evictable,
            kv_blocks_free=alloc.num_free,
            ttft_ewma_s=self._fold_ttft(),
            queue_wait_p50_ms=(float(np.percentile(qwait, 50)) * 1e3
                               if qwait else None),
        )

    # ------------------------------------------------------------------ #
    def chain_keys(self, prompt: Sequence[int]) -> List[bytes]:
        cache = self.server.prefix_cache
        if cache is None:
            return []
        return cache.keys_for(np.asarray(prompt, np.int32))

    def predicted_cached_tokens(self, prompt: Sequence[int],
                                keys: Optional[List[bytes]] = None) -> int:
        """Prompt tokens this replica would serve from its prefix
        cache if the request were admitted right now (0 without a
        cache).  ``keys`` short-circuits rehashing when the caller
        already chained them (block size is fleet-uniform)."""
        cache = self.server.prefix_cache
        if cache is None:
            return 0
        if keys is None:
            keys = self.chain_keys(prompt)
        return cache.probe(keys) * cache.block_size


__all__ = ["LoadSignal", "Replica", "TTFT_EWMA_ALPHA"]
