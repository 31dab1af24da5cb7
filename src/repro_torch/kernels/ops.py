"""Public entry points of the port's kernels.

Each picks its path from where its inputs lie: a CPU tensor takes the
plain PyTorch version (``repro_torch.kernels.ref``), a CUDA tensor
launches the hand-written kernel, which raises on what it does not
take.  No path falls back to the other.  (The reference picks Pallas
interpret mode the same way, in ``repro/kernels/ops.py``.)
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels.ref import paged_attention_ref, selective_scan_ref

#: every kernel wrapper with a launch count, by kernel name
WRAPPERS = {"paged_attention": _pa.paged_attention,
            "selective_scan": _ss.selective_scan,
            "selective_scan_fwd_ckpt": _ss.selective_scan_fwd_ckpt,
            "selective_scan_bwd": _ss.selective_scan_bwd}


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Block-indexed decode attention over a paged KV cache:
    q [B, H, D], pools [N, bs, Hkv, D], block_tables [B, M] int32,
    lengths [B] int32 -> [B, H, D]."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths)
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, lengths)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor, *,
                   trainable: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Mamba-1 scan: dt/x [B, S, D], b/c [B, S, N], a [D, N],
    h0 [B, D, N] -> (y [B, S, D] in x.dtype, h_final [B, D, N] float32).
    ``trainable=True`` takes the differentiable kernel pair (checkpointing
    forward, recomputing backward); on the CPU the plain recurrence is
    differentiable by autograd either way."""
    if x.device.type == "cpu":
        return selective_scan_ref(dt, x, b, c, a, h0)
    if trainable:
        return _ss.selective_scan_trainable(dt, x, b, c, a, h0)
    return _ss.selective_scan(dt, x, b, c, a, h0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["WRAPPERS", "launch_counts", "paged_attention",
           "paged_attention_ref", "reset_launch_counts", "selective_scan",
           "selective_scan_ref"]
