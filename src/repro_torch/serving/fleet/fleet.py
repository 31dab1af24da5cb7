"""``FleetServer``: N serving replicas in lockstep waves behind a
telemetry-driven router with admission control.

The scale-out rung above one ``ContinuousBatchingServer``: a front-end
that **admits** (queue cap + per-tenant token buckets,
``admission.py``), **routes** (pluggable policies over each replica's
``load_signal()``, ``router.py``), and **steps** every replica one
scheduler iteration per wave (``Replica.step``, the extracted
``server.step_once``).  Waves are the fleet's logical clock: replicas
are stepped in index order, routing is a pure function of load
signals, and arrival times are wave-stamped -- so a fixed trace
replays bitwise and every fleet counter can gate in CI.

Determinism contract: with greedy sampling, per-request token streams
are **bitwise identical across fleet sizes** under any deterministic
routing policy -- each slot row's logits depend only on its own paged
context and sampling keys are per ``(rid, position)``, so *where* a
request lands (replica, slot, batch neighbors) never changes *what* it
generates.  ``tests/test_torch_fleet.py`` holds ``--replicas 1`` vs N,
and the port's fleet to the reference's.

Metrics flow through ``repro_torch.obs.registry``: per-replica gauges
carry a ``replica`` label, rejection counters a ``tenant`` label (which
is why label-value escaping in the exposition format matters).

The port's counterpart of ``repro/serving/fleet/fleet.py``.  Every
replica holds the one ``params`` tree it is given, by reference: the
fleet adds only each replica's page pool to the device's memory, never a
copy of the weights.  ``grid=`` (this rank's ``GridComm``) stripes every
replica's slot rows over ``dp_axis``, as the reference's ``mesh=``;
``device=`` is the servers' (default ``cuda``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.serving.fleet.admission import (AdmissionConfig,
                                           AdmissionController, Rejection)
from repro_torch.serving.fleet.replica import Replica
from repro_torch.serving.fleet.router import Router, make_router
from repro_torch.serving.scheduler import Request
from repro_torch.serving.server import ContinuousBatchingServer
from repro_torch.serving.telemetry import TelemetrySnapshot

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class FleetSnapshot:
    """Fleet-aggregate view + the per-replica snapshots behind it."""
    waves: int
    n_replicas: int
    replicas: Tuple[TelemetrySnapshot, ...]
    routed: Tuple[int, ...]             # requests sent to each replica
    submitted: int                      # offered to admission
    admitted: int
    rejected: int
    rejected_by_reason: Dict[str, int]
    rejected_below_cap: int
    # fleet-wide prefix-cache effectiveness (the tentpole headline:
    # affinity routing keeps this near the single-replica fraction)
    prefill_tokens_computed: int
    cached_prefix_tokens: int
    cached_token_fraction: float
    tokens_out: int
    queue_depth_max: Tuple[int, ...]    # per replica, over the history


class FleetServer:
    """Drive N ``ContinuousBatchingServer`` replicas in lockstep."""

    def __init__(self, cfg, params, n_replicas: int, batch_size: int,
                 max_len: int, *, router: Union[str, Router] = "round_robin",
                 admission: Optional[AdmissionConfig] = None,
                 seed: int = 0, grid=None, dp_axis: str = "data",
                 engine=None, **server_kw):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.cfg = cfg
        # every replica gets the same seed: sampling keys are per
        # (rid, position) off the server key, so a request draws the
        # same tokens whichever replica it lands on (the fleet-size
        # determinism contract)
        self.replicas = [
            Replica(i, ContinuousBatchingServer(
                cfg, params, batch_size, max_len, seed=seed, grid=grid,
                dp_axis=dp_axis, engine=engine, **server_kw))
            for i in range(n_replicas)]
        self.router = (router if isinstance(router, Router)
                       else make_router(router, cfg))
        self.admission = AdmissionController(admission or AdmissionConfig())
        self.wave = 0
        self.submitted = 0
        self.tokens_out: Dict[int, int] = {}
        self.routed = [0] * n_replicas
        self.routed_replica: Dict[int, int] = {}    # rid -> replica

    # ------------------------------------------------------------------ #
    def fleet_queue_depth(self) -> int:
        """Requests waiting for a slot, fleet-wide (what the admission
        cap bounds; admitted in-flight work is not re-counted)."""
        return sum(len(r.server.scheduler.queue) for r in self.replicas)

    def submit(self, req: Request, tenant: str = DEFAULT_TENANT
               ) -> Optional[Rejection]:
        """Admit -> route -> enqueue one request.  Returns None when
        accepted, else the :class:`Rejection` (with its retry-after
        hint in waves) -- the request was *not* enqueued."""
        self.submitted += 1
        rej = self.admission.admit(
            req, tenant, fleet_queue_depth=self.fleet_queue_depth(),
            wave=self.wave)
        if rej is not None:
            return rej
        signals = [r.load_signal() for r in self.replicas]
        i = self.router.route(req, self.replicas, signals)
        if not 0 <= i < len(self.replicas):
            raise ValueError(f"router {self.router.name!r} returned "
                             f"replica {i} of {len(self.replicas)}")
        self.replicas[i].submit(req)
        self.routed[i] += 1
        self.routed_replica[req.rid] = i
        return None

    # ------------------------------------------------------------------ #
    def run_wave(self) -> Dict[int, List[int]]:
        """Step every replica one scheduler iteration (index order)
        and advance the wave clock.  Returns requests finished this
        wave ({rid: tokens})."""
        finished: Dict[int, List[int]] = {}
        for rep in self.replicas:
            if rep.has_work():
                finished.update(rep.step().finished)
        self.wave += 1
        return finished

    def has_work(self) -> bool:
        return any(r.has_work() for r in self.replicas)

    def run(self, max_waves: Optional[int] = None) -> Dict[int, List[int]]:
        """Drain every replica (or stop after ``max_waves``); returns
        {rid: generated tokens} including partials at a wave budget."""
        results: Dict[int, List[int]] = {}
        if max_waves is None:
            max_waves = float("inf")
        waves = 0
        while self.has_work() and waves < max_waves:
            results.update(self.run_wave())
            waves += 1
        for rep in self.replicas:
            for rid, toks in rep.results().items():
                results.setdefault(rid, toks)
        return results

    def run_trace(self, arrivals: Iterable[Tuple[int, str, Request]],
                  max_waves: Optional[int] = None
                  ) -> Tuple[Dict[int, List[int]], List[Rejection]]:
        """Serve a wave-stamped arrival trace: ``(wave, tenant,
        request)`` triples in non-decreasing wave order.  Each wave
        first submits everything due, then steps the fleet; idle waves
        (drained replicas, future arrivals) still tick the clock.
        Returns (results, rejections)."""
        pending = deque(sorted(arrivals, key=lambda a: a[0]))
        results: Dict[int, List[int]] = {}
        rejections: List[Rejection] = []
        if max_waves is None:
            max_waves = float("inf")
        waves = 0
        while (pending or self.has_work()) and waves < max_waves:
            while pending and pending[0][0] <= self.wave:
                _, tenant, req = pending.popleft()
                rej = self.submit(req, tenant)
                if rej is not None:
                    rejections.append(rej)
            results.update(self.run_wave())
            waves += 1
        for rep in self.replicas:
            for rid, toks in rep.results().items():
                results.setdefault(rid, toks)
        return results, rejections

    # ------------------------------------------------------------------ #
    def snapshot(self) -> FleetSnapshot:
        snaps = tuple(r.server.snapshot() for r in self.replicas)
        computed = sum(s.prefill_tokens_computed for s in snaps)
        cached = sum(s.cached_prefix_tokens for s in snaps)
        total = computed + cached
        return FleetSnapshot(
            waves=self.wave,
            n_replicas=len(self.replicas),
            replicas=snaps,
            routed=tuple(self.routed),
            submitted=self.submitted,
            admitted=self.admission.admitted,
            rejected=self.admission.rejected,
            rejected_by_reason=dict(self.admission.rejected_by_reason),
            rejected_below_cap=self.admission.rejected_below_cap,
            prefill_tokens_computed=computed,
            cached_prefix_tokens=cached,
            cached_token_fraction=(cached / total if total else 0.0),
            tokens_out=sum(s.tokens_out for s in snaps),
            queue_depth_max=tuple(s.queue_depth_max for s in snaps),
        )


def export_fleet_stats(fleet: FleetServer, registry=None):
    """Mirror a fleet's aggregate + per-replica state into a
    :class:`repro_torch.obs.registry.MetricsRegistry` (the process-wide one by
    default).  Per-replica gauges carry a ``replica`` label; rejection
    counts a ``tenant`` label (tenant ids are label values -- the
    exposition escaping path).  Returns the registry."""
    from repro_torch.obs import registry as obs_registry
    from repro_torch.serving.telemetry import export_to_registry
    reg = registry if registry is not None else obs_registry.REGISTRY
    snap = fleet.snapshot()

    def g(name, value, help_, labels=None):
        if value is None:
            return
        reg.gauge(name, labels=labels, help=help_).set(float(value))

    g("fleet_waves", snap.waves, "lockstep waves driven")
    g("fleet_replicas", snap.n_replicas, "serving replicas")
    g("fleet_submitted", snap.submitted, "requests offered to admission")
    g("fleet_admitted", snap.admitted, "requests past admission control")
    g("fleet_rejected", snap.rejected, "requests shed by admission")
    g("fleet_rejected_below_cap", snap.rejected_below_cap,
      "rejections issued with queue headroom left (contract: 0)")
    g("fleet_tokens_out", snap.tokens_out, "tokens generated fleet-wide")
    g("fleet_prefill_tokens_computed", snap.prefill_tokens_computed,
      "prompt tokens computed fleet-wide")
    g("fleet_cached_prefix_tokens", snap.cached_prefix_tokens,
      "prompt tokens served from prefix caches fleet-wide")
    g("fleet_cached_token_fraction", snap.cached_token_fraction,
      "fleet-wide cached / (cached + computed) prefill tokens")
    for reason, n in sorted(snap.rejected_by_reason.items()):
        g("fleet_rejected_by_reason", n, "rejections per reason",
          labels={"reason": reason})
    by_tenant: Dict[str, int] = {}
    for rej in fleet.admission.rejections:
        by_tenant[rej.tenant] = by_tenant.get(rej.tenant, 0) + 1
    for tenant, n in sorted(by_tenant.items()):
        g("fleet_rejected_by_tenant", n, "rejections per tenant",
          labels={"tenant": tenant})
    for i, s in enumerate(snap.replicas):
        export_to_registry(s, reg, prefix=f"fleet_replica_{i}")
        g("fleet_routed", snap.routed[i], "requests routed per replica",
          labels={"replica": str(i)})
        g("fleet_replica_queue_depth_max", s.queue_depth_max,
          "max queued depth per replica", labels={"replica": str(i)})
    return reg


__all__ = ["DEFAULT_TENANT", "FleetServer", "FleetSnapshot",
           "export_fleet_stats"]
