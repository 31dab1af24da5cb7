"""The serving engine: paged KV cache + continuous batching over the
CollectiveEngine (counterpart of ``repro/serving/server.py``).

``ContinuousBatchingServer`` glues the host-side ``Scheduler`` to the
paged model entry points (``repro_torch.models.paged``):

* **prefill chunks** run one request at a time at the padded
  ``[1, prefill_chunk]`` shape -- the same shape for every chunk, as the
  reference keeps one compiled program, which also keeps the prefix
  cache on/off streams bitwise equal; a vision request's soft tokens
  lead its first chunk (of every prefill, a replay after preemption
  included) and its context, and it is never prefix-cached;
* **decode** runs over the full slot array ``[B, 1]``, idle slots masked
  to the scratch block; on CUDA its attention is the hand-written
  block-indexed kernel, on the CPU the kernel's plain version;
* **sampling** is per (request, position) id, so tokens do not depend on
  slot placement.

Data-parallel serving (``grid=``, this rank's ``GridComm``; one server
per rank) stripes the slot rows over the ``dp_axis`` as the reference's
``mesh=`` does.  Every rank runs the same deterministic scheduler over
the whole batch, and runs every prefill chunk itself, so each rank's KV
pool holds every prompt.  A decode step serves only this rank's stripe
of slot rows: they are live in the call, writing their new K/V into the
rank's own pool, and the other ranks' rows are idle in it (masked to
the scratch block, as a single server's empty slots are).  The call
keeps the server's ``[B, 1]`` shape on purpose: cuBLAS picks its GEMM
kernel by the row count, and a stripe-shaped call rounds some rows
differently (on an H100 the unembedding ``[M, 2304] @ [2304, 122753]``
of ``minicpm-2b`` at M 1 or 2 against M 4 or 8), which flips greedy
tokens at near-ties; at the slot shape every row is computed as one
server computes it (ROADMAP C20).  The per-rank sampled tokens are
assembled through the engine's cached model-driven ``allgather_inside``
over the DP axis, so that every rank's scheduler sees the global token
vector.  The pools stay coherent for what each rank reads: blocks
shared between rows (the prefix cache, copy-on-write sources) are only
ever written by prefill, which every rank runs, and a row's decode K/V
is read only by the rank that owns its slot.

PyTorch runs eagerly, so nothing is traced or compiled; the KV pool is
updated in place where the reference donates it to each program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.collectives.comm import GridComm
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.paged import (copy_blocks, decode_step_paged,
                                      forward_paged, init_pages,
                                      supports_paged)
from repro_torch.serving.blocks import BlockAllocator
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampling import sample_tokens
from repro_torch.serving.scheduler import (PrefillChunk, Request, Scheduler,
                                           RUNNING)
from repro_torch.serving.telemetry import Telemetry, TelemetrySnapshot

#: sample-id stride per request; bounds max_new_tokens per request.
#: ids wrap modulo 2^31, as in the reference: determinism only needs ids
#: to be a pure function of (rid, position)
_SAMPLE_STRIDE = 1 << 20
_SAMPLE_MOD = 1 << 31


@dataclasses.dataclass(frozen=True)
class StepOutcome:
    """What one scheduler iteration did."""
    finished: Dict[int, List[int]]      # rid -> tokens retired this step
    decoded: bool                       # a decode batch launched
    progressed: bool                    # False = nothing active (drained)


class ContinuousBatchingServer:
    """Paged-cache continuous-batching server on ``device`` (default
    ``cuda``; the CPU only when asked for); with ``grid`` (this rank's
    ``GridComm``) one data-parallel rank of a server striped over
    ``dp_axis``."""

    def __init__(self, cfg, params, batch_size: int, max_len: int,
                 seed: int = 0, grid: Optional[GridComm] = None,
                 dp_axis: str = "data", engine=None, *,
                 device: DeviceLike = None,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32, prefill_per_step: int = 1,
                 top_k: int = 0, prefix_cache: bool = True):
        if not supports_paged(cfg):
            raise NotImplementedError(
                f"serving covers the dense and MoE decoder families, not "
                f"{cfg.family!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server on {self.device}")
        if grid is not None and grid.device.type != self.device.type:
            raise ValueError(f"the grid's ranks live on {grid.device}, the "
                             f"server on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch_size
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.max_blocks_per_seq = -(-max_len // block_size)
        if num_blocks is None:
            num_blocks = batch_size * self.max_blocks_per_seq + 1
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.prefix_cache = (PrefixCache(self.allocator) if prefix_cache
                             else None)
        self.scheduler = Scheduler(batch_size, self.allocator,
                                   self.max_blocks_per_seq, prefill_chunk,
                                   prefill_per_step,
                                   prefix_cache=self.prefix_cache)
        self.telemetry = Telemetry()
        self.top_k = top_k          # default for requests with top_k=0
        self.seed = seed
        # decode attention: the CUDA kernel on the GPU, its plain version
        # on the CPU
        self.use_kernel = self.device.type == "cuda"
        self._step = 0
        self.pages = init_pages(cfg, num_blocks, block_size, self.device)

        self.grid = grid
        self.dp_axis = dp_axis
        self._engine = engine
        self.assembly_decision = None
        self.assembly_regime = None
        self._rows = slice(0, batch_size)       # this rank's slot rows
        if grid is not None:
            n_dp = grid.axis_size(dp_axis)
            if batch_size % n_dp != 0:
                raise ValueError(
                    f"batch {batch_size} not divisible by dp axis {n_dp}")
            if engine is None:
                from repro_torch.collectives.api import get_engine
                self._engine = get_engine(device=grid.device)
            self._dp_comm = grid.sub(dp_axis)
            per = batch_size // n_dp
            self._rows = slice(self._dp_comm.rank * per,
                               (self._dp_comm.rank + 1) * per)
            # Decode token assembly gathers one int32 per sequence over
            # the DP axis -- a few hundred bytes, below the latency /
            # bandwidth crossover.  The planner's decision, computed
            # once, says which side of it the serving hot path landed on.
            eng = self._engine
            dec = eng.select("allgather", batch_size * 4, n_dp,
                             fabric=eng.topology.for_axis(dp_axis))
            self.assembly_decision = dec
            self.assembly_regime = ("latency" if dec.algorithm == "oneshot"
                                    else "bandwidth")

    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        """Queue ``req``; a vision request carries its soft tokens as
        ``soft_emb`` [1, n_soft, D] (a tensor or a numpy array), fed to
        the model on its first prefill chunk."""
        self.scheduler.submit(req, now=self.telemetry.now())
        self.telemetry.record_submit()

    def snapshot(self) -> TelemetrySnapshot:
        return self.telemetry.snapshot(
            queue_depth=len(self.scheduler.queue),
            active=len(self.scheduler.active()),
            allocator=self.allocator,
            block_usage=self.scheduler.block_usage())

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    # ------------------------------------------------------------------ #
    def _sample_rows(self, logits: torch.Tensor, reqs: List[Request],
                     rows: List[int], gathered: bool = False
                     ) -> np.ndarray:
        """logits [B, V] -> host tokens [B]; per-(request, position) ids
        make the result independent of slot placement and of DP.  With
        ``gathered``, ``logits`` holds this rank's stripe of the slot
        rows: it samples those and the engine's allgather over the DP
        axis assembles the whole batch's tokens."""
        b = self.batch if gathered else logits.shape[0]
        sids = np.zeros((b,), np.int64)
        temps = np.zeros((b,), np.float32)
        topks = np.zeros((b,), np.int32)
        for row, req in zip(rows, reqs):
            sids[row] = (req.rid * _SAMPLE_STRIDE
                         + len(req.out)) % _SAMPLE_MOD
            temps[row] = req.sampling.temperature
            topks[row] = req.sampling.top_k or self.top_k
        if gathered:
            sids, temps, topks = (a[self._rows] for a in (sids, temps,
                                                          topks))
        if not np.any(temps > 0):       # all-greedy hot path: argmax only
            toks = torch.argmax(logits.float(), dim=-1)
        else:
            toks = sample_tokens(logits, self._tensor(sids),
                                 self._tensor(temps), self.seed,
                                 self._tensor(topks))
        if gathered:
            toks = self._engine.allgather_inside(toks.to(torch.int32),
                                                 self._dp_comm)
        return toks.cpu().numpy()

    def _append_token(self, req: Request, token: int) -> None:
        req.out.append(int(token))
        self.telemetry.record_tokens(1)
        if req.first_token_t is None:
            req.first_token_t = self.telemetry.now()
            self.telemetry.record_first_token(req.arrival_t)
        if len(req.out) >= req.max_new_tokens:
            req.done = True
            req.finish_t = self.telemetry.now()
            req.finish_step = self._step
            self.telemetry.record_finish()

    # ------------------------------------------------------------------ #
    def _run_prefill_chunk(self, chunk: PrefillChunk) -> None:
        req, start, n = chunk.req, chunk.start, chunk.length
        replay = req.replay_tokens
        tokens = np.zeros((1, self.prefill_chunk), np.int32)
        tokens[0, :n] = replay[start:start + n]
        bt = np.zeros((1, self.max_blocks_per_seq), np.int32)
        bt[0, :len(req.table.blocks)] = req.table.blocks
        ctx = np.asarray([req.ctx_len], np.int32)
        new_len = np.asarray([n], np.int32)
        batch = {"tokens": self._tensor(tokens)}
        if start == 0 and req.soft_emb is not None:
            # the soft tokens lead the context, on the first chunk of
            # every (re)prefill, a replay after preemption included
            soft = req.soft_emb
            batch["soft_emb"] = (soft if torch.is_tensor(soft)
                                 else torch.from_numpy(np.asarray(soft))
                                 ).to(self.device)
        logits, self.pages = forward_paged(
            self.params, self.cfg, self.pages, batch, self._tensor(bt),
            self._tensor(ctx), self._tensor(new_len), use_kernel=False)
        if "soft_emb" in batch:
            req.ctx_len += req.n_soft
        req.prefilled += n
        req.ctx_len += n
        self.telemetry.record_prefill_tokens(n)
        self.scheduler.note_prefilled(req)
        if req.prefilled == len(replay):
            # prompt fully cached: the chunk's last valid position
            # yields this request's next token (its first, unless it
            # was preempted mid-decode and replayed)
            req.state = RUNNING
            tok = self._sample_rows(logits[:, n - 1], [req], [0])
            self._append_token(req, int(tok[0]))

    def _run_decode(self) -> None:
        running = self.scheduler.running()
        rows = [i for i, _ in running]
        reqs = [r for _, r in running]
        tokens = np.zeros((self.batch, 1), np.int32)
        bt = np.zeros((self.batch, self.max_blocks_per_seq), np.int32)
        ctx = np.zeros((self.batch,), np.int32)
        sl = self._rows
        for i, req in running:
            if not sl.start <= i < sl.stop:
                continue    # another DP rank's row: idle here
            tokens[i, 0] = req.out[-1]
            bt[i, :len(req.table.blocks)] = req.table.blocks
            ctx[i] = req.ctx_len
        logits, self.pages = decode_step_paged(
            self.params, self.cfg, self.pages,
            {"tokens": self._tensor(tokens)}, self._tensor(bt),
            self._tensor(ctx), use_kernel=self.use_kernel)
        toks = self._sample_rows(logits[sl, 0], reqs, rows,
                                 gathered=self.grid is not None)
        for i, req in running:
            req.ctx_len += 1
            self._append_token(req, int(toks[i]))

    # ------------------------------------------------------------------ #
    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step_once(self) -> StepOutcome:
        """One scheduler iteration: retire, admit, apply CoW copies,
        prefill chunks, decode (at most one batch).  A stalled scheduler
        (queued work that can never be admitted) raises."""
        results: Dict[int, List[int]] = {}
        for req in self.scheduler.retire_finished():
            results[req.rid] = req.out
        now = self.telemetry.now()
        for req in self.scheduler.admit(self._step):
            self.telemetry.record_queue_wait(now - req.arrival_t)
            if req.cached_prefix_tokens:
                self.telemetry.record_cached_prefix(
                    req.cached_prefix_tokens)
        cows = self.scheduler.drain_cow_copies()
        if cows:
            # private replacements for shared blocks about to be
            # written; must land before this step's prefill chunks
            src = torch.tensor([s for s, _ in cows], device=self.device)
            dst = torch.tensor([d for _, d in cows], device=self.device)
            self.pages = copy_blocks(self.pages, src, dst)
        if not self.scheduler.active():
            if self.scheduler.queue:
                raise RuntimeError(
                    "serving stalled: queued request cannot be "
                    "admitted (KV block pool too small?)")
            return StepOutcome(results, decoded=False, progressed=False)
        plan = self.scheduler.prefill_plan()
        for chunk in plan:
            self._run_prefill_chunk(chunk)
        decoded = False
        if self.scheduler.any_running():
            for _ in self.scheduler.grow_for_decode():
                self.telemetry.record_preemption()
            if self.scheduler.any_running():
                self._run_decode()
                decoded = True
        self.telemetry.record_step(decoded=decoded,
                                   prefill_chunks=len(plan),
                                   kv_occupancy=self.allocator.occupancy,
                                   queue_depth=len(self.scheduler.queue))
        self._step += 1
        if not plan and not decoded and not any(
                r.done for r in self.scheduler.slots if r):
            raise RuntimeError("scheduler made no progress")
        return StepOutcome(results, decoded=decoded, progressed=True)

    def run(self, max_steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Serve until queue + slots drain, or ``max_steps`` decode
        iterations when given.  Returns {rid: generated tokens} (partial
        outputs included when a step budget ends first)."""
        results: Dict[int, List[int]] = {}
        decode_steps = 0
        if max_steps is None:
            max_steps = float("inf")
        while self.scheduler.has_work():
            out = self.step_once()
            results.update(out.finished)
            if not out.progressed:
                break       # drained
            decode_steps += int(out.decoded)
            if decode_steps >= max_steps:
                break
        for req in self.scheduler.retire_finished():
            results[req.rid] = req.out
        # step budget exhausted: report partial generations
        for _, req in self.scheduler.active():
            results.setdefault(req.rid, req.out)
        for req in self.scheduler.queue:
            results.setdefault(req.rid, req.out)
        return results


__all__ = ["ContinuousBatchingServer", "Request", "StepOutcome"]
