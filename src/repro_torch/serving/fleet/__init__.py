"""Multi-replica serving fleet: telemetry-driven routing + admission.

The port's counterpart of ``repro/serving/fleet`` (README: "The
serving fleet and checkpoints of the port").  Components:

* ``replica``   -- one ``ContinuousBatchingServer`` + its cheap
                   ``load_signal()`` (queue depth, live/evictable KV
                   split, in-flight prefill tokens, TTFT EWMA)
* ``router``    -- pluggable deterministic policies: ``round_robin``,
                   ``least_queue``, ``cost`` (modeled admission cost
                   for the uncached suffix), ``prefix_affinity``
* ``admission`` -- fleet queue cap with reject + retry-after, and
                   per-tenant token-bucket rate limiting (wave-clocked)
* ``fleet``     -- ``FleetServer`` lockstep orchestration
                   (submit -> route -> step -> drain) + registry export
* ``trace``     -- wave-stamped arrival generation (fixed / poisson /
                   bursty MMPP), shared with the benches and the CLI
"""

from repro_torch.serving.fleet.admission import (REJECT_QUEUE_FULL,
                                           REJECT_RATE_LIMITED,
                                           AdmissionConfig,
                                           AdmissionController, Rejection)
from repro_torch.serving.fleet.fleet import (DEFAULT_TENANT, FleetServer,
                                       FleetSnapshot, export_fleet_stats)
from repro_torch.serving.fleet.replica import LoadSignal, Replica
from repro_torch.serving.fleet.router import (ROUTER_POLICIES, CostRouter,
                                        LeastQueueRouter,
                                        PrefixAffinityRouter,
                                        RoundRobinRouter, Router,
                                        make_router)
from repro_torch.serving.fleet.trace import ARRIVAL_MODES, arrival_waves

__all__ = [
    "ARRIVAL_MODES", "AdmissionConfig", "AdmissionController",
    "CostRouter", "DEFAULT_TENANT", "FleetServer", "FleetSnapshot",
    "LeastQueueRouter", "LoadSignal", "PrefixAffinityRouter",
    "REJECT_QUEUE_FULL", "REJECT_RATE_LIMITED",
    "ROUTER_POLICIES", "Rejection", "Replica", "RoundRobinRouter",
    "Router", "arrival_waves", "export_fleet_stats", "make_router",
]
