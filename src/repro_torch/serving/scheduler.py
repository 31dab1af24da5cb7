"""Continuous-batching scheduler: admit and retire every decode step.

Pure host-side bookkeeping (no torch): the scheduler owns the slot array,
the request queue, and the block accounting; the ``Server`` executes the
plan it produces.  Policies:

* **Iteration-level scheduling** -- finished requests release their
  slot + blocks at the top of every step and queued requests are
  admitted into freed slots *in the same step* (no waves, no padding
  rows decoding garbage: idle slots are masked to the scratch block).
* **Chunked prefill** -- admitted requests stream their prompt in
  fixed-size chunks, at most ``prefill_per_step`` chunks per iteration
  while decode is active (long prompts never stall token emission);
  when nothing is decoding, the full idle capacity prefills.
* **Out-of-blocks preemption** -- when a running request cannot get a
  block to grow its context, the latest-admitted active request is
  preempted vLLM-recompute-style: its blocks are released and it is
  re-queued at the front with ``prompt + generated`` as the new prompt
  context.  Sampling keys are per (request, position), so the replay
  reuses the keys of the original run: greedy replays are token-exact;
  stochastic replays match up to the fp32-level agreement between the
  prefill and decode attention paths (a draw sitting exactly on a
  categorical boundary could differ).
* **Prefix caching** (``prefix_cache=``) -- admission matches the
  longest cached run of full prompt blocks (hash-chained content keys,
  ``serving/prefix_cache.py``), takes shared references on the matched
  physical blocks, and starts chunked prefill at the first uncached
  token.  A *full* hit drops back one token -- the final prompt
  position is recomputed so first-step logits exist -- and since that
  write lands in the last matched (shared, immutable) block, the block
  is **copied-on-write**: admission allocates a private replacement and
  queues a ``(src, dst)`` pool copy the server executes before any
  prefill of the step.  Preemption and retirement ``decref`` rather
  than free, so shared blocks survive their first owner and park on
  the evictable LRU at refcount 0.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.serving.blocks import (BlockAllocator, BlockTable,
                                       BlockUsage)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import SamplingParams

QUEUED = "queued"
PREFILLING = "prefilling"
RUNNING = "running"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One generation request.

    The leading fields match the legacy ``launch.serve.Request`` wire
    format (rid, prompt, max_new_tokens, out, done); the rest is
    scheduler-managed runtime state.
    """
    rid: int
    prompt: np.ndarray                  # [S] int32
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    sampling: SamplingParams = SamplingParams()
    soft_emb: Optional[Any] = None      # [1, n_soft, D] vision embeddings

    state: str = QUEUED
    table: Optional[BlockTable] = None
    ctx_len: int = 0                    # positions in cache (incl. soft)
    prefilled: int = 0                  # replay tokens already cached
    cached_prefix_tokens: int = 0       # skipped via prefix cache (this
                                        # admission; server reads after
                                        # admit and accumulates)
    _chain_keys: List[bytes] = dataclasses.field(default_factory=list)
    _cache_upto: int = 0                # table blocks already inserted
    arrival_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    admit_step: Optional[int] = None
    finish_step: Optional[int] = None
    _admit_seq: int = -1

    @property
    def n_soft(self) -> int:
        return 0 if self.soft_emb is None else int(self.soft_emb.shape[1])

    @property
    def replay_tokens(self) -> np.ndarray:
        """Prompt context to (re)prefill: prompt plus anything already
        generated (recompute-style preemption resumes through here)."""
        if not self.out:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.out, np.int32)])


@dataclasses.dataclass(frozen=True)
class PrefillChunk:
    req: Request
    start: int      # offset into replay_tokens
    length: int     # valid tokens this chunk (<= prefill_chunk)


class Scheduler:
    def __init__(self, batch_size: int, allocator: BlockAllocator,
                 max_blocks_per_seq: int, prefill_chunk: int,
                 prefill_per_step: int = 1,
                 prefix_cache: Optional[PrefixCache] = None):
        self.batch_size = batch_size
        self.allocator = allocator
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefill_chunk = prefill_chunk
        self.prefill_per_step = prefill_per_step
        self.prefix_cache = prefix_cache
        #: pending copy-on-write pool copies (src block, dst block) the
        #: server must execute before the step's first prefill
        self.cow_copies: List[Tuple[int, int]] = []
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: Deque[Request] = deque()
        self._admit_seq = 0

    # ------------------------------------------------------------------ #
    def validate(self, req: Request) -> None:
        if len(req.prompt) == 0:
            # the first sampled token comes from the last *token*
            # position of the prefill; an empty prompt has none
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens < 1")
        total = req.n_soft + len(req.prompt) + req.max_new_tokens
        max_tokens = self.max_blocks_per_seq * self.allocator.block_size
        if total > max_tokens:
            raise ValueError(
                f"request {req.rid}: {total} tokens exceeds max_len "
                f"{max_tokens}")
        if self.allocator.blocks_for(total) > self.allocator.capacity:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{self.allocator.blocks_for(total)} blocks, pool has "
                f"{self.allocator.capacity}")

    def submit(self, req: Request, now: Optional[float] = None) -> None:
        self.validate(req)
        req.arrival_t = time.monotonic() if now is None else now
        req.state = QUEUED
        self.queue.append(req)

    # ------------------------------------------------------------------ #
    def has_work(self) -> bool:
        return bool(self.queue) or any(self.slots)

    def active(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    def running(self) -> List[Tuple[int, Request]]:
        """Decodable rows: RUNNING and not already done (a request can
        finish at prefill time and must not decode before retiring)."""
        return [(i, r) for i, r in self.active()
                if r.state == RUNNING and not r.done]

    def any_running(self) -> bool:
        return bool(self.running())

    def context_lens(self) -> List[int]:
        return [r.ctx_len for _, r in self.active()]

    def block_usage(self) -> List[BlockUsage]:
        """Per-request (block ids, context length) pairs for unique-
        block fragmentation accounting under prefix sharing."""
        return [(r.table.blocks, r.ctx_len) for _, r in self.active()]

    # ------------------------------------------------------------------ #
    def retire_finished(self) -> List[Request]:
        """Free slots + blocks of done requests (called every step)."""
        out = []
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                req.table.release()
                req.state = FINISHED
                self.slots[i] = None
                out.append(req)
        return out

    def _try_admit(self, req: Request) -> Optional[BlockTable]:
        """All-or-nothing block grant for one request, sharing the
        longest cached prefix run first.  On grant, ``req.prefilled`` /
        ``ctx_len`` start past the shared tokens (prefill resumes at
        the first uncached token); on a full hit the final token is
        recomputed, with the last matched block replaced copy-on-write
        (the recompute writes into it).  Failure restores the cache
        references it took."""
        replay = req.replay_tokens
        bs = self.allocator.block_size
        need_total = max(
            self.allocator.blocks_for(req.n_soft + len(replay)), 1)
        matched: List[int] = []
        keys: List[bytes] = []
        cow_src: Optional[int] = None
        if self.prefix_cache is not None and req.n_soft == 0:
            keys = self.prefix_cache.keys_for(replay)
            matched = self.prefix_cache.match(keys)
            if matched and len(matched) * bs == len(replay):
                cow_src = matched[-1]
        got = self.allocator.alloc(
            need_total - len(matched) + (1 if cow_src is not None else 0))
        if got is None:
            for blk in matched:
                self.allocator.decref(blk)
            return None
        table = BlockTable(self.allocator)
        if cow_src is not None:
            # full hit: got[0] is the private replacement for the last
            # matched block; the pool copy runs before the recompute
            # chunk writes position len(replay)-1 into it
            self.cow_copies.append((cow_src, got[0]))
            self.allocator.decref(cow_src)
            table.blocks = matched[:-1] + got
            cached = len(replay) - 1
        else:
            table.blocks = matched + got
            cached = len(matched) * bs
        req._chain_keys = keys
        req._cache_upto = len(matched)
        req.cached_prefix_tokens = cached
        req.prefilled = cached
        req.ctx_len = cached            # cacheable requests have n_soft=0
        return table

    def admit(self, step: int) -> List[Request]:
        """FCFS-fill free slots from the queue; all-or-nothing block
        grants keep admission atomic.  Stops at the first request that
        does not fit (no starvation of large requests)."""
        admitted = []
        for i in range(self.batch_size):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            table = self._try_admit(req)
            if table is None:
                break
            self.queue.popleft()
            req.table = table
            req.state = PREFILLING
            req.admit_step = step if req.admit_step is None else \
                req.admit_step
            req._admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slots[i] = req
            admitted.append(req)
        return admitted

    def drain_cow_copies(self) -> List[Tuple[int, int]]:
        """Pending (src, dst) pool copies from this step's admissions;
        the server must apply them before any prefill runs."""
        out, self.cow_copies = self.cow_copies, []
        return out

    def note_prefilled(self, req: Request) -> None:
        """Register the request's freshly fully-written blocks in the
        prefix cache (called after each executed prefill chunk)."""
        if self.prefix_cache is None or not req._chain_keys:
            return
        upto = min(req.prefilled // self.allocator.block_size,
                   len(req._chain_keys))
        for i in range(req._cache_upto, upto):
            self.prefix_cache.insert(req._chain_keys[i],
                                     req.table.blocks[i])
        req._cache_upto = max(req._cache_upto, upto)

    def prefill_plan(self) -> List[PrefillChunk]:
        """Next prompt chunks: ``prefill_per_step`` while decode is
        live, otherwise the whole idle batch prefills."""
        budget = (self.prefill_per_step if self.any_running()
                  else self.batch_size)
        plan = []
        pref = [r for _, r in self.active() if r.state == PREFILLING]
        pref.sort(key=lambda r: r._admit_seq)
        for req in pref[:budget]:
            replay = req.replay_tokens
            n = min(self.prefill_chunk, len(replay) - req.prefilled)
            plan.append(PrefillChunk(req, req.prefilled, n))
        return plan

    # ------------------------------------------------------------------ #
    def _preempt(self, req: Request) -> None:
        """Recompute-style: release the blocks (decref -- shared and
        cached ones survive for the replay to re-match), re-queue at
        the front."""
        req.table.release()
        req.table = None
        req.state = QUEUED
        req.ctx_len = 0
        req.prefilled = 0
        req.cached_prefix_tokens = 0
        req._chain_keys = []
        req._cache_upto = 0
        for i, r in enumerate(self.slots):
            if r is req:
                self.slots[i] = None
        self.queue.appendleft(req)

    def grow_for_decode(self) -> List[Request]:
        """Ensure every running request has a slot for its next token,
        preempting the latest-admitted active request on exhaustion."""
        preempted = []
        for _, req in self.running():
            # an earlier row's growth may have preempted this one
            # (state left RUNNING only while it still owns its slot)
            while req.state == RUNNING and not req.done and \
                    not req.table.ensure_capacity(req.ctx_len + 1):
                # done-but-unretired requests are not preemptible: a
                # replay would generate past max_new_tokens (their
                # blocks free at the next retire anyway)
                victims = [r for _, r in self.active()
                           if r.state in (PREFILLING, RUNNING)
                           and not r.done]
                victim = max(victims, key=lambda r: r._admit_seq)
                self._preempt(victim)
                preempted.append(victim)
                if victim is req:
                    break
        return preempted


__all__ = ["Request", "PrefillChunk", "Scheduler",
           "QUEUED", "PREFILLING", "RUNNING", "FINISHED"]
