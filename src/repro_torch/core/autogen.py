"""Auto-Gen Reduce (Sec. 5.5): DP over pre-order reduction trees.

The DP computes, in unit-vector-length ("per element") terms,

    E(P, D, C) = min_i  E(i, D, C-1) + E(P-i, D-1, C) + i

the minimum energy of a reduce over P consecutive PEs with depth <= D and
per-PE contention <= C.  The runtime estimate for vector length B is then

    T(P, B) = min_{(D, C)}  max(C*B, B*E(P,D,C)/(P-1) + P-1) + D*(2*T_R+1)

and the optimal tree is recovered by backtracking the argmin splits.  The
tree generalizes Star (star graph), Chain (path), Tree and Two-Phase, so
Auto-Gen matches or beats every fixed pattern under the model (Sec. 5.5).

Exploring all (D, C) pairs up to P is O(P^4); we restrict the search to the
downward-closed region  {C <= c_small}  U  {D <= d_small}  which provably
contains every pattern family the model can favor (chain-like solutions
need large D but C ~ 1..c_small; star-like solutions need large C but
D ~ 1..d_small; everything in between has both small).  Tables are cached
on disk keyed by the region parameters.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.model import Fabric, WSE2
from repro_torch.core.schedule import ReduceTree

_DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                                  "..", "var", "cache_torch")


def cache_dir() -> str:
    """On-disk cache root shared by the Auto-Gen tables and the
    CollectiveEngine decision cache.  Override with REPRO_TORCH_CACHE_DIR.

    The port's namespace: neither the variable nor the default directory
    is the JAX package's (``REPRO_CACHE_DIR``, ``var/cache``), so the two
    packages never read or write each other's files."""
    return os.environ.get("REPRO_TORCH_CACHE_DIR", _DEFAULT_CACHE_DIR)

INF = np.float32(np.inf)


@dataclasses.dataclass
class AutoGenTables:
    """DP tables over the explored (D, C) region."""

    p_max: int
    pairs: List[Tuple[int, int]]          # explored (d, c) pairs
    pair_index: Dict[Tuple[int, int], int]
    energy: np.ndarray                    # [n_pairs, p_max + 1] float32
    split: np.ndarray                     # [n_pairs, p_max + 1] int16 argmin i

    def e(self, d: int, c: int, p: int) -> float:
        idx = self.pair_index.get((d, c))
        if idx is None:
            return float("inf")
        return float(self.energy[idx, p])


def _region_pairs(d_max: int, c_max: int, d_small: int, c_small: int
                  ) -> List[Tuple[int, int]]:
    pairs = []
    for d in range(1, d_max + 1):
        c_hi = c_max if d <= d_small else c_small
        for c in range(1, c_hi + 1):
            pairs.append((d, c))
    return pairs


def compute_tables(p_max: int, d_max: Optional[int] = None,
                   c_max: Optional[int] = None, d_small: int = 12,
                   c_small: int = 16, use_cache: bool = True) -> AutoGenTables:
    """Fill the Auto-Gen DP tables for all P <= p_max."""
    if d_max is None:
        d_max = max(p_max - 1, 1)
    if c_max is None:
        c_max = max(p_max - 1, 1)
    d_max = max(1, min(d_max, p_max - 1 if p_max > 1 else 1))
    c_max = max(1, min(c_max, p_max - 1 if p_max > 1 else 1))
    d_small = min(d_small, d_max)
    c_small = min(c_small, c_max)

    cache_key = f"autogen_P{p_max}_D{d_max}_C{c_max}_ds{d_small}_cs{c_small}"
    cache_path = os.path.join(cache_dir(), cache_key + ".npz")
    pairs = _region_pairs(d_max, c_max, d_small, c_small)
    pair_index = {pc: k for k, pc in enumerate(pairs)}

    if use_cache and os.path.exists(cache_path):
        data = np.load(cache_path)
        return AutoGenTables(p_max, pairs, pair_index,
                             data["energy"], data["split"])

    n = len(pairs)
    energy = np.full((n, p_max + 1), INF, dtype=np.float32)
    split = np.zeros((n, p_max + 1), dtype=np.int16)
    energy[:, 1] = 0.0  # single PE: nothing to do
    if p_max == 1:
        return AutoGenTables(p_max, pairs, pair_index, energy, split)

    # Precompute index helpers for the min-plus convolution:
    #   M[P] = min_{1<=i<=P-1}  (A[i] + i) + B2[P-i]
    i_vals = np.arange(1, p_max, dtype=np.int64)          # i = 1..p_max-1
    p_vals = np.arange(0, p_max + 1, dtype=np.int64)      # P = 0..p_max
    diff = p_vals[None, :] - i_vals[:, None]              # P - i
    valid = diff >= 1
    diff_clip = np.clip(diff, 0, p_max)

    zero_c = np.full(p_max + 1, INF, dtype=np.float32)    # E(., d, 0)
    zero_c[1] = 0.0
    zero_d = zero_c                                        # E(., 0, c)

    for k, (d, c) in enumerate(pairs):
        a = energy[pair_index[(d, c - 1)]] if c >= 2 else zero_c
        b2 = energy[pair_index[(d - 1, c)]] if (d - 1, c) in pair_index \
            else (zero_d if d == 1 else None)
        if b2 is None:
            # (d-1, c) outside region: can only happen when c > c_small and
            # d == d_small + 1, which _region_pairs excludes.  Guard anyway.
            b2 = zero_d
        av = a[1:p_max].astype(np.float32) + i_vals.astype(np.float32)
        mat = av[:, None] + np.where(valid, b2[diff_clip], INF)
        energy[k] = np.minimum(mat.min(axis=0), energy[k])
        split[k] = np.argmin(mat, axis=0) + 1
        energy[k, 1] = 0.0

    if use_cache:
        os.makedirs(cache_dir(), exist_ok=True)
        # unique per process and thread: the ranks of a local grid are
        # threads of one process, and two of them may build one table
        tmp = (cache_path
               + f".tmp{os.getpid()}.{threading.get_ident()}.npz")
        np.savez_compressed(tmp, energy=energy, split=split)
        os.replace(tmp, cache_path)
    return AutoGenTables(p_max, pairs, pair_index, energy, split)


# ---------------------------------------------------------------------- #
# runtime evaluation + tree extraction
# ---------------------------------------------------------------------- #
def t_autogen(p: int, b: int, fabric: Fabric = WSE2,
              tables: Optional[AutoGenTables] = None
              ) -> Tuple[float, Tuple[int, int]]:
    """Best model runtime over the explored (D, C) region, and its (D, C)."""
    if p == 1:
        return 0.0, (0, 0)
    if tables is None or tables.p_max < p:
        tables = compute_tables(p)
    ds = np.array([d for d, _ in tables.pairs], dtype=np.float64)
    cs = np.array([c for _, c in tables.pairs], dtype=np.float64)
    e = tables.energy[:, p].astype(np.float64)
    bw = fabric.link_bw
    t = (np.maximum(cs * b / bw, b * e / ((p - 1) * bw) + (p - 1))
         + ds * fabric.per_depth_cost)
    t = np.where(np.isfinite(e), t, np.inf)
    k = int(np.argmin(t))
    return float(t[k]), tables.pairs[k]


def autogen_tree(p: int, b: int, fabric: Fabric = WSE2,
                 tables: Optional[AutoGenTables] = None) -> ReduceTree:
    """Extract the optimal ordered reduction tree for (P, B)."""
    if tables is None or tables.p_max < p:
        tables = compute_tables(p)
    _, (d_opt, c_opt) = t_autogen(p, b, fabric, tables)
    parent = [-1] * p
    children: List[List[int]] = [[] for _ in range(p)]

    def build(offset: int, pp: int, d: int, c: int) -> None:
        if pp <= 1:
            return
        k = tables.pair_index[(d, c)]
        i = int(tables.split[k, pp])
        if not (1 <= i <= pp - 1):
            raise AssertionError(f"bad split {i} for (P={pp}, D={d}, C={c})")
        # earlier children of `offset` come from the left part [offset, offset+i)
        build(offset, i, d, c - 1)
        # last (pipelined) child: vertex offset+i owns [offset+i, offset+pp)
        child = offset + i
        parent[child] = offset
        children[offset].append(child)
        build(child, pp - i, d - 1, c)

    if p > 1:
        build(0, p, d_opt, c_opt)
    tree = ReduceTree(parent, children, root=0,
                      label=f"autogen(D={d_opt},C={c_opt})")
    tree.validate()
    return tree


__all__ = ["AutoGenTables", "cache_dir", "compute_tables", "t_autogen",
           "autogen_tree"]
