"""Serving telemetry: TTFT, throughput, queue depth, KV occupancy.

The server records events as they happen; ``snapshot()`` freezes them
into an immutable dataclass (the thing a metrics exporter would ship).
Percentiles are computed at snapshot time from the raw TTFT samples.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """Point-in-time view of the serving loop."""
    elapsed_s: float
    steps: int                  # scheduler iterations
    decode_steps: int
    prefill_chunks: int
    submitted: int
    finished: int
    preemptions: int
    queue_depth: int
    active: int
    tokens_out: int
    tok_per_s: float            # generated tokens / elapsed
    ttft_p50_ms: Optional[float]
    ttft_p99_ms: Optional[float]
    kv_blocks_total: int
    kv_blocks_used: int
    kv_occupancy: float
    kv_peak_occupancy: float
    kv_internal_frag_slots: int
    ttft_samples: int = 0       # how many TTFTs back the percentiles
    # -- prefix cache ------------------------------------------------- #
    # live = refcount >= 1 (true load); evictable = refcount-0 cached
    # blocks kept resident (cache pressure, reclaimable on demand)
    kv_blocks_live: int = 0
    kv_blocks_evictable: int = 0
    prefill_tokens_computed: int = 0
    cached_prefix_tokens: int = 0
    cached_token_fraction: float = 0.0
    prefix_evictions: int = 0
    # -- admission / router signals ----------------------------------- #
    # submit -> admit latency percentiles (the head-of-line wait a
    # router's load signal should see, not just instantaneous depth)
    queue_wait_p50_ms: Optional[float] = None
    queue_wait_samples: int = 0
    # per-step queued-depth history rollups (deterministic for a fixed
    # trace: steps are logical, not wall clock)
    queue_depth_max: int = 0
    queue_depth_history: Tuple[int, ...] = ()


class Telemetry:
    """Mutable collector behind the snapshot."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.t0 = clock()
        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.submitted = 0
        self.finished = 0
        self.preemptions = 0
        self.tokens_out = 0
        self.prefill_tokens_computed = 0
        self.cached_prefix_tokens = 0
        self.peak_kv_occupancy = 0.0
        self.ttft_s: List[float] = []
        self.queue_wait_s: List[float] = []
        self.queue_depth_history: List[int] = []

    def record_submit(self) -> None:
        self.submitted += 1

    def record_first_token(self, arrival_t: float) -> None:
        self.ttft_s.append(self._clock() - arrival_t)

    def record_tokens(self, n: int) -> None:
        self.tokens_out += n

    def record_prefill_tokens(self, n: int) -> None:
        """Prompt tokens actually computed by a prefill chunk."""
        self.prefill_tokens_computed += n

    def record_cached_prefix(self, n: int) -> None:
        """Prompt tokens served from the prefix cache at admission."""
        self.cached_prefix_tokens += n

    def record_finish(self) -> None:
        self.finished += 1

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_queue_wait(self, wait_s: float) -> None:
        """Submit -> admit latency of one admitted request."""
        self.queue_wait_s.append(wait_s)

    def record_step(self, *, decoded: bool, prefill_chunks: int,
                    kv_occupancy: float = 0.0,
                    queue_depth: Optional[int] = None) -> None:
        self.steps += 1
        self.decode_steps += int(decoded)
        self.prefill_chunks += prefill_chunks
        self.peak_kv_occupancy = max(self.peak_kv_occupancy, kv_occupancy)
        if queue_depth is not None:
            self.queue_depth_history.append(int(queue_depth))

    def now(self) -> float:
        return self._clock()

    def snapshot(self, *, queue_depth: int, active: int, allocator,
                 block_usage: List) -> TelemetrySnapshot:
        elapsed = max(self._clock() - self.t0, 1e-9)
        ttft = np.asarray(self.ttft_s, np.float64)
        qwait = np.asarray(self.queue_wait_s, np.float64)
        prefill_total = self.prefill_tokens_computed + \
            self.cached_prefix_tokens
        return TelemetrySnapshot(
            elapsed_s=elapsed,
            steps=self.steps,
            decode_steps=self.decode_steps,
            prefill_chunks=self.prefill_chunks,
            submitted=self.submitted,
            finished=self.finished,
            preemptions=self.preemptions,
            queue_depth=queue_depth,
            active=active,
            tokens_out=self.tokens_out,
            tok_per_s=self.tokens_out / elapsed,
            ttft_p50_ms=(float(np.percentile(ttft, 50)) * 1e3
                         if ttft.size else None),
            ttft_p99_ms=(float(np.percentile(ttft, 99)) * 1e3
                         if ttft.size else None),
            ttft_samples=int(ttft.size),
            kv_blocks_total=allocator.capacity,
            kv_blocks_used=allocator.num_used,
            kv_occupancy=allocator.occupancy,
            kv_peak_occupancy=max(self.peak_kv_occupancy,
                                  allocator.occupancy),
            kv_internal_frag_slots=allocator.internal_fragmentation(
                block_usage),
            kv_blocks_live=allocator.num_used,
            kv_blocks_evictable=allocator.num_evictable,
            prefill_tokens_computed=self.prefill_tokens_computed,
            cached_prefix_tokens=self.cached_prefix_tokens,
            cached_token_fraction=(self.cached_prefix_tokens /
                                   prefill_total if prefill_total else 0.0),
            prefix_evictions=allocator.evictions,
            queue_wait_p50_ms=(float(np.percentile(qwait, 50)) * 1e3
                               if qwait.size else None),
            queue_wait_samples=int(qwait.size),
            queue_depth_max=(max(self.queue_depth_history)
                             if self.queue_depth_history else 0),
            queue_depth_history=tuple(self.queue_depth_history),
        )


#: below this many TTFT samples the percentiles are statistically
#: shaky; exporters keep them but mark them low-confidence.
TTFT_LOW_CONFIDENCE = 20


def ttft_low_confidence(snap: TelemetrySnapshot) -> bool:
    """True when the snapshot's TTFT percentiles rest on too few
    samples to trust (fewer than :data:`TTFT_LOW_CONFIDENCE`)."""
    return snap.ttft_samples < TTFT_LOW_CONFIDENCE


def export_to_registry(snap: TelemetrySnapshot, registry=None,
                       prefix: str = "serve"):
    """Mirror a snapshot into a :class:`repro_torch.obs.MetricsRegistry`
    (the process-wide one by default), as the reference does.  Returns
    the registry.

    Percentile gauges are exported alongside ``{prefix}_ttft_samples``
    and a 0/1 ``{prefix}_ttft_low_confidence`` flag rather than being
    suppressed -- consumers decide what a thin sample base means."""
    from repro_torch.obs import registry as obs_registry
    reg = registry if registry is not None else obs_registry.REGISTRY

    def g(name: str, value, help_: str) -> None:
        if value is None:
            return
        reg.gauge(f"{prefix}_{name}", help=help_).set(float(value))

    g("elapsed_s", snap.elapsed_s, "serving loop wall time")
    g("steps", snap.steps, "scheduler iterations")
    g("decode_steps", snap.decode_steps, "decode batches launched")
    g("prefill_chunks", snap.prefill_chunks, "prefill chunks executed")
    g("submitted", snap.submitted, "requests submitted")
    g("finished", snap.finished, "requests finished")
    g("preemptions", snap.preemptions, "requests preempted")
    g("queue_depth", snap.queue_depth, "requests waiting")
    g("active", snap.active, "requests in flight")
    g("tokens_out", snap.tokens_out, "tokens generated")
    g("tok_per_s", snap.tok_per_s, "generation throughput")
    g("ttft_p50_ms", snap.ttft_p50_ms, "median time to first token")
    g("ttft_p99_ms", snap.ttft_p99_ms, "p99 time to first token")
    g("ttft_samples", snap.ttft_samples,
      "TTFT observations behind the percentiles")
    g("ttft_low_confidence", int(ttft_low_confidence(snap)),
      f"1 when ttft_samples < {TTFT_LOW_CONFIDENCE}")
    g("kv_blocks_total", snap.kv_blocks_total, "KV pool capacity")
    g("kv_blocks_used", snap.kv_blocks_used, "KV blocks in use")
    g("kv_occupancy", snap.kv_occupancy, "KV pool occupancy")
    g("kv_peak_occupancy", snap.kv_peak_occupancy,
      "peak KV pool occupancy")
    g("kv_internal_frag_slots", snap.kv_internal_frag_slots,
      "slots lost to block-internal fragmentation")
    g("kv_blocks_live", snap.kv_blocks_live,
      "KV blocks referenced by live requests (true load)")
    g("kv_blocks_evictable", snap.kv_blocks_evictable,
      "refcount-0 cached KV blocks resident until pool pressure")
    g("prefill_tokens_computed", snap.prefill_tokens_computed,
      "prompt tokens actually computed in prefill")
    g("cached_prefix_tokens", snap.cached_prefix_tokens,
      "prompt tokens served from the prefix cache")
    g("cached_token_fraction", snap.cached_token_fraction,
      "cached / (cached + computed) prefill tokens")
    g("prefix_evictions", snap.prefix_evictions,
      "cached blocks reclaimed under pool pressure")
    g("queue_wait_p50_ms", snap.queue_wait_p50_ms,
      "median submit -> admit latency")
    g("queue_wait_samples", snap.queue_wait_samples,
      "admissions behind the queue-wait percentiles")
    g("queue_depth_max", snap.queue_depth_max,
      "max queued depth over the per-step history")
    return reg


__all__ = ["Telemetry", "TelemetrySnapshot", "TTFT_LOW_CONFIDENCE",
           "ttft_low_confidence", "export_to_registry"]
