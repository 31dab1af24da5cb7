"""Fleet admission control: queue cap + per-tenant token buckets.

Backpressure lives at the front end, before routing: a request the
fleet cannot absorb is **rejected with a retry-after hint** instead of
growing an unbounded queue (graceful shed under burst).  Two gates:

* **Fleet queue cap** -- when the fleet-wide *queued* depth (requests
  waiting for a slot, summed over replicas; admitted work is already
  paid for) has reached ``queue_cap``, new arrivals are shed.  The
  retry-after hint is the number of admissions that must happen before
  the depth drops below the cap -- in waves, the fleet's logical
  clock, so the hint is deterministic for a fixed trace.
* **Per-tenant token bucket** -- each tenant refills ``tenant_rate``
  tokens per wave up to a burst capacity; a request costs its prompt
  plus requested output tokens.  A tenant bursting past its budget is
  rejected with the waves-until-refill hint while other tenants keep
  being admitted (per-tenant isolation, not global shed).

Both clocks are *waves* (scheduler iterations), not wall time: the
controller's decisions replay bitwise for a fixed trace, which is what
lets a bench gate "zero rejects below the cap" as a deterministic
counter (``rejected_below_cap``).  The port's copy of
``repro/serving/fleet/admission.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.serving.scheduler import Request

REJECT_QUEUE_FULL = "queue_full"
REJECT_RATE_LIMITED = "rate_limited"


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    #: max fleet-wide queued (not yet admitted) requests; None = uncapped
    queue_cap: Optional[int] = None
    #: token-bucket refill per tenant per wave (prompt + output tokens);
    #: None disables rate limiting
    tenant_rate: Optional[float] = None
    #: bucket capacity (burst allowance); defaults to 8x the rate
    tenant_burst: Optional[float] = None

    def burst(self) -> float:
        if self.tenant_burst is not None:
            return self.tenant_burst
        return 8.0 * (self.tenant_rate or 0.0)


@dataclasses.dataclass(frozen=True)
class Rejection:
    rid: int
    tenant: str
    reason: str                 # REJECT_QUEUE_FULL | REJECT_RATE_LIMITED
    retry_after_waves: int      # earliest wave offset worth retrying at
    wave: int                   # when the rejection happened


class AdmissionController:
    """Wave-clocked backpressure in front of the router."""

    def __init__(self, config: AdmissionConfig):
        self.config = config
        self._level: Dict[str, float] = {}      # tenant -> bucket level
        self._last_wave: Dict[str, int] = {}
        self.rejections: List[Rejection] = []
        self.admitted = 0
        self.rejected_by_reason: Dict[str, int] = {
            REJECT_QUEUE_FULL: 0, REJECT_RATE_LIMITED: 0}
        #: queue-full rejections issued while the fleet queue was below
        #: the cap.  Structurally zero -- the gate only fires at
        #: ``depth >= cap`` -- but exported and benched as a counter so
        #: the "rejections only above the cap" contract is *asserted*,
        #: not assumed.
        self.rejected_below_cap = 0

    # ------------------------------------------------------------------ #
    @staticmethod
    def request_tokens(req: Request) -> float:
        """What a request costs against its tenant's budget."""
        return float(len(req.prompt) + req.max_new_tokens)

    def _bucket(self, tenant: str, wave: int) -> float:
        cfg = self.config
        level = self._level.get(tenant, cfg.burst())
        delta = wave - self._last_wave.get(tenant, wave)
        if delta > 0 and cfg.tenant_rate:
            level = min(cfg.burst(), level + cfg.tenant_rate * delta)
        self._level[tenant] = level
        self._last_wave[tenant] = wave
        return level

    def _reject(self, req: Request, tenant: str, reason: str,
                retry_after: int, wave: int,
                fleet_queue_depth: int) -> Rejection:
        rej = Rejection(req.rid, tenant, reason,
                        retry_after_waves=retry_after, wave=wave)
        self.rejections.append(rej)
        self.rejected_by_reason[reason] += 1
        # audit the shed contract: with a cap configured and headroom
        # left, nothing should be shed (token-bucket rejections count
        # too when rate limiting is off -- the bench runs it that way)
        if self.config.queue_cap is not None and \
                fleet_queue_depth < self.config.queue_cap:
            self.rejected_below_cap += 1
        return rej

    # ------------------------------------------------------------------ #
    def admit(self, req: Request, tenant: str, *, fleet_queue_depth: int,
              wave: int) -> Optional[Rejection]:
        """Gate one arrival.  Returns None on admit (tenant budget
        deducted) or the :class:`Rejection` to surface to the client."""
        cfg = self.config
        if cfg.queue_cap is not None and \
                fleet_queue_depth >= cfg.queue_cap:
            # hint: admissions needed before depth drops below the cap
            retry = fleet_queue_depth - cfg.queue_cap + 1
            return self._reject(req, tenant, REJECT_QUEUE_FULL,
                                retry, wave, fleet_queue_depth)
        if cfg.tenant_rate:
            cost = self.request_tokens(req)
            level = self._bucket(tenant, wave)
            if level < cost:
                retry = math.ceil((cost - level) / cfg.tenant_rate)
                return self._reject(req, tenant, REJECT_RATE_LIMITED,
                                    retry, wave, fleet_queue_depth)
            self._level[tenant] = level - cost
        self.admitted += 1
        return None

    @property
    def rejected(self) -> int:
        return len(self.rejections)


__all__ = ["AdmissionConfig", "AdmissionController", "Rejection",
           "REJECT_QUEUE_FULL", "REJECT_RATE_LIMITED"]
