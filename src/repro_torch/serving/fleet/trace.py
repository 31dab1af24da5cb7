"""Arrival-time generation for serving traces.

ROADMAP: "benchmark under skewed, bursty multi-tenant traces, not
uniform arrivals".  This module owns the arrival clock -- in *waves*
(fleet scheduler iterations), the logical time base that keeps every
downstream counter deterministic for a fixed seed:

* ``fixed``   -- everything arrives at wave 0 (the legacy
                 submit-all-up-front behavior committed baselines
                 assume).
* ``poisson`` -- independent arrivals at ``rate`` requests/wave.
* ``bursty``  -- a 2-state Markov-modulated Poisson process: a calm
                 state at ``rate`` and a burst state at
                 ``burst_factor * rate``, switching with geometric
                 dwell times.  Bursts are what make admission control
                 and telemetry-driven routing earn their keep; a plain
                 Poisson stream rarely fills a queue cap.

Shared by the ``launch/serve.py`` ``--arrival`` flag and
``chip_smoke.py``'s fleet phase (the reference's benches use it too).
Draws come from a dedicated ``numpy`` Generator so the prompt-content
RNG stream of existing traces is untouched (fixed baselines stay green).
The port's copy of ``repro/serving/fleet/trace.py``: the same waves for
the same seed.
"""

from __future__ import annotations

from typing import List

import numpy as np

ARRIVAL_MODES = ("fixed", "poisson", "bursty")


def arrival_waves(n: int, mode: str = "fixed", *,
                  rng: np.random.Generator = None,
                  rate: float = 2.0, burst_factor: float = 8.0,
                  p_enter_burst: float = 0.1,
                  p_exit_burst: float = 0.3) -> List[int]:
    """Non-decreasing arrival waves for ``n`` requests.

    ``rate`` is the calm-state mean arrivals per wave; ``bursty`` mode
    multiplies it by ``burst_factor`` while in the burst state and
    switches states with the given per-wave probabilities (mean dwell
    ``1/p``).  Requests are assigned to waves in submission order.
    """
    if mode not in ARRIVAL_MODES:
        raise ValueError(f"unknown arrival mode {mode!r}; choose from "
                         f"{ARRIVAL_MODES}")
    if mode == "fixed" or n == 0:
        return [0] * n
    if rng is None:
        raise ValueError(f"arrival mode {mode!r} needs a seeded rng")
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    waves: List[int] = []
    wave = 0
    burst = False
    while len(waves) < n:
        lam = rate * (burst_factor if burst else 1.0)
        k = int(rng.poisson(lam))
        waves.extend([wave] * min(k, n - len(waves)))
        if mode == "bursty":
            if burst:
                burst = rng.random() >= p_exit_burst
            else:
                burst = rng.random() < p_enter_burst
        wave += 1
    return waves


__all__ = ["ARRIVAL_MODES", "arrival_waves"]
