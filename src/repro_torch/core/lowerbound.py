"""Lower bounds for 1D Reduce (Lemma 5.5) and helpers.

The 1D lower bound is a DP over (split, depth) decompositions:

    E*(P, 1, D) >= min_i  E*(i, 1, D) + E*(P-i, 1, D-1) + min(i, P-i+1)

with E*(1, 1, D) = 0 and E*(P, 1, 0) = inf for P >= 2.  The runtime bound
(contention dropped -- it only weakens a lower bound) is

    T*(P, B) >= min_D  B * E*(P, 1, D) / (P-1) + (P-1) + D*(2*T_R+1)
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from repro_torch.core.autogen import cache_dir
from repro_torch.core.model import Fabric, WSE2

INF = np.float32(np.inf)


def compute_lb_energy(p_max: int, d_max: Optional[int] = None,
                      use_cache: bool = True) -> np.ndarray:
    """Return table ``e[d, P]`` = E*(P, 1, D=d) for d in 0..d_max.

    Note the self-reference E*(i, D) on the *same* depth level, which forces
    an in-order sweep over P per level.
    """
    if d_max is None:
        d_max = max(p_max - 1, 1)
    d_max = max(1, min(d_max, max(p_max - 1, 1)))

    cache_path = os.path.join(cache_dir(), f"lb_P{p_max}_D{d_max}.npy")
    if use_cache and os.path.exists(cache_path):
        return np.load(cache_path)

    e = np.full((d_max + 1, p_max + 1), INF, dtype=np.float32)
    e[:, 1] = 0.0
    # extra cost of the last message: min(i, P - i + 1) for split at i
    for d in range(1, d_max + 1):
        for p in range(2, p_max + 1):
            i = np.arange(1, p, dtype=np.int64)
            extra = np.minimum(i, p - i + 1).astype(np.float32)
            cand = e[d, 1:p] + e[d - 1, p - 1:0:-1] + extra
            e[d, p] = cand.min()
    if use_cache:
        os.makedirs(cache_dir(), exist_ok=True)
        tmp = (cache_path
               + f".tmp{os.getpid()}.{threading.get_ident()}.npy")
        np.save(tmp, e)
        os.replace(tmp, cache_path)
    return e


def t_lower_bound(p: int, b: int, fabric: Fabric = WSE2,
                  lb_table: Optional[np.ndarray] = None) -> float:
    """T*(P, B): minimum over depth of the three cost contributions."""
    if p == 1:
        return 0.0
    if lb_table is None or lb_table.shape[1] <= p:
        lb_table = compute_lb_energy(p)
    d_max = lb_table.shape[0] - 1
    ds = np.arange(1, d_max + 1, dtype=np.float64)
    e = lb_table[1:, p].astype(np.float64)
    t = (b * e / ((p - 1) * fabric.link_bw) + (p - 1)
         + ds * fabric.per_depth_cost)
    t = np.where(np.isfinite(e), t, np.inf)
    return float(t.min())


def t_all_to_all_lower_bound(p: int, b: int, fabric: Fabric = WSE2) -> float:
    """Theta(B*(P-1)/P) injection bound for AllToAll (personalized
    exchange, no reduction): every device must send -- and receive --
    B*(P-1)/P elements through its own ramp, in at least one launch:

        T*(P, B) >= B*(P-1)/P / link_bw + (2*T_R + 1)

    Topology effects (the ring-bisection ~B*P/4 per-link load of a
    single-shot folded exchange) only raise candidate costs above this;
    dropping them keeps it a bound on every implemented pattern."""
    if p <= 1:
        return 0.0
    return b * (p - 1) / p / fabric.link_bw + fabric.per_depth_cost


__all__ = ["compute_lb_energy", "t_lower_bound", "t_all_to_all_lower_bound"]
