"""Pluggable fleet routing policies.

Every policy is a deterministic pure function of the request and the
replicas' load signals (ties resolve to the lowest replica index), so a
fleet run is replayable and the bench counters gate bitwise:

* ``round_robin``     -- replica-oblivious cycling; the baseline the
                         model-driven policies must beat.
* ``least_queue``     -- send the request where the least prefill
                         compute is already committed (queued +
                         in-flight prompt tokens, backlog tie-break);
                         bounds per-replica prefill imbalance.
* ``cost``            -- score each replica by *modeled admission
                         cost*: the roofline-priced prefill seconds for
                         the request's **uncached suffix** on that
                         replica (hash-chain probe of its prefix cache
                         predicts the cached prefix length) plus the
                         prefill seconds already committed there.  The
                         serving-layer analogue of the paper's
                         model-driven algorithm selection: dispatch on
                         predicted cost, not a blind heuristic.
* ``prefix_affinity`` -- pin each hash-chain prefix (tenant / shared
                         system prompt) to the replica holding its
                         blocks, so the fleet-wide cached-token
                         fraction approaches the single-replica one
                         instead of diluting 1/N under oblivious
                         routing.  Falls back to least-committed-work
                         for never-seen prefixes and records the pin.

``make_router(policy, cfg)`` builds one; policies are stateful (the
round-robin cursor, the affinity pin map) but never consult wall
clocks or RNGs.

The port's copy of ``repro/serving/fleet/router.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.launch.roofline import PEAK_FLOPS
from repro_torch.serving.fleet.replica import LoadSignal, Replica
from repro_torch.serving.scheduler import Request


def _argmin(scores: Sequence[float]) -> int:
    """Lowest-index argmin (deterministic tie-break)."""
    best = 0
    for i, s in enumerate(scores):
        if s < scores[best]:
            best = i
    return best


class Router:
    """Base policy: ``route`` returns the target replica index."""

    name = "base"

    def route(self, req: Request, replicas: List[Replica],
              signals: List[LoadSignal]) -> int:
        raise NotImplementedError


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def route(self, req, replicas, signals) -> int:
        i = self._next % len(replicas)
        self._next += 1
        return i


class LeastQueueRouter(Router):
    name = "least_queue"

    def route(self, req, replicas, signals) -> int:
        return _argmin([(s.pending_prefill_tokens, s.backlog, s.replica)
                        for s in signals])


class CostRouter(Router):
    """Modeled admission cost in seconds, per replica::

        cost(r) = p_tok * (uncached_suffix_tokens(req, r)
                           + pending_prefill_tokens(r))

    with ``p_tok = 2 * active_params / PEAK_FLOPS`` (the roofline
    inference-compute price per token).  The uncached suffix is
    predicted from the replica's prefix cache by probing the request's
    hash-chain keys -- the same content addressing admission will use,
    so the prediction only errs when blocks are evicted in between.
    """

    name = "cost"

    def __init__(self, cfg):
        self.price_per_token_s = 2.0 * cfg.active_param_count() / PEAK_FLOPS
        #: modeled cost of each routed request (seconds), for telemetry
        self.last_costs: List[float] = []

    def admission_cost_s(self, req: Request, replica: Replica,
                         signal: LoadSignal,
                         keys: Optional[List[bytes]] = None) -> float:
        cached = replica.predicted_cached_tokens(req.prompt, keys)
        uncached = max(len(req.prompt) - cached, 0)
        return self.price_per_token_s * (
            uncached + signal.pending_prefill_tokens)

    def route(self, req, replicas, signals) -> int:
        keys = replicas[0].chain_keys(req.prompt)
        costs = [self.admission_cost_s(req, r, s, keys)
                 for r, s in zip(replicas, signals)]
        self.last_costs = costs
        return _argmin([(c, s.replica) for c, s in zip(costs, signals)])


class PrefixAffinityRouter(Router):
    """Route a hash-chain prefix to the replica that owns its blocks.

    The pin is keyed by the *first* chain key (one full block of
    prompt), so every request opening with the same system prompt lands
    on the same replica even while the first one is still queued and
    nothing is inserted in the cache yet -- the burst case oblivious
    routing loses.  Unpinned prefixes go to the replica with the
    longest predicted cached run (if any), else to the least committed
    prefill work; either way the choice is recorded as the pin.
    """

    name = "prefix_affinity"

    def __init__(self):
        self._pin: Dict[bytes, int] = {}

    def route(self, req, replicas, signals) -> int:
        keys = replicas[0].chain_keys(req.prompt)
        pin_key = keys[0] if keys else None
        if pin_key is not None:
            pinned = self._pin.get(pin_key)
            if pinned is not None and pinned < len(replicas):
                return pinned
        cached = [r.predicted_cached_tokens(req.prompt, keys)
                  for r in replicas]
        if max(cached, default=0) > 0:
            choice = _argmin([(-c, s.replica)
                              for c, s in zip(cached, signals)])
        else:
            choice = _argmin([(s.pending_prefill_tokens, s.backlog,
                               s.replica) for s in signals])
        if pin_key is not None:
            self._pin[pin_key] = choice
        return choice


ROUTER_POLICIES = ("round_robin", "least_queue", "cost", "prefix_affinity")


def make_router(policy: str, cfg=None) -> Router:
    """Build a router by policy name (``cfg`` required for ``cost``)."""
    if policy == "round_robin":
        return RoundRobinRouter()
    if policy == "least_queue":
        return LeastQueueRouter()
    if policy == "cost":
        if cfg is None:
            raise ValueError("cost router needs the model config to "
                             "price prefill compute")
        return CostRouter(cfg)
    if policy == "prefix_affinity":
        return PrefixAffinityRouter()
    raise ValueError(f"unknown router policy {policy!r}; "
                     f"choose from {ROUTER_POLICIES}")


__all__ = ["Router", "RoundRobinRouter", "LeastQueueRouter", "CostRouter",
           "PrefixAffinityRouter", "ROUTER_POLICIES", "make_router"]
