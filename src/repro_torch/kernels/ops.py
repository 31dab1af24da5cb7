"""Public entry points of the port's kernels.

Each picks its path from where its inputs lie: a CPU tensor takes the
plain PyTorch version (``repro_torch.kernels.ref``), a CUDA tensor
launches the hand-written kernel, which raises on what it does not
take.  No path falls back to the other.  (The reference picks Pallas
interpret mode the same way, in ``repro/kernels/ops.py``.)

A meta tensor takes the kernel route of the model paths' kernels
(flash, paged, the scans, ``matmul_tiled``) with each kernel's
shape-only body (``*_meta``): the outputs, and for the differentiable
kernels the saved tensors, that the card's route allocates, with
nothing launched or counted.  The dry-run (``launch.dryrun``) sizes a
step's memory so; :func:`on_card_route` is the models' test for that
route.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul_tiled as _mt
from repro_torch.kernels import multi_add as _ma
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels.ref import (flash_attention_ref, matmul_tiled_ref,
                                     multi_add_ref, paged_attention_ref,
                                     selective_scan_ref)

#: every kernel wrapper with a launch count, by kernel name
WRAPPERS = {"paged_attention": _pa.paged_attention,
            "selective_scan": _ss.selective_scan,
            "selective_scan_fwd_ckpt": _ss.selective_scan_fwd_ckpt,
            "selective_scan_bwd": _ss.selective_scan_bwd,
            "multi_add": _ma.multi_add,
            "matmul_tiled": _mt.matmul_tiled_cuda,
            "flash_attention": _fa.flash_attention_cuda}


def on_card_route(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels' route: a CUDA tensor (the
    kernels) or a meta tensor (their shape-only bodies)."""
    return x.device.type in ("cuda", "meta")


def multi_add(stacked: torch.Tensor) -> torch.Tensor:
    """Sum K stacked partials: [K, N] -> [N] with float32 accumulation,
    in the input dtype."""
    if stacked.device.type == "cpu":
        return multi_add_ref(stacked)
    return _ma.multi_add(stacked)


def matmul_tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M, K] @ [K, N] -> [M, N]``, float32 accumulation, in x's dtype;
    differentiable (the kernel's backward is the reference's dense one).
    The block GEMM of the fused matmul + ring reduce-scatter."""
    if x.device.type == "cpu":
        return matmul_tiled_ref(x, w)
    return _mt.MatmulTiledFn.apply(x, w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """Attention ``[B, H, S, D] x [B, Hkv, S, D] -> [B, H, S, D]`` with
    GQA, causal masking and an optional sliding window; differentiable
    (on a CUDA tensor the kernel forward with the plain flash backward,
    on a CPU tensor autograd through the plain version)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, window)[0]
    return _fa.FlashAttentionFn.apply(q, k, v, causal, window)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Block-indexed decode attention over a paged KV cache:
    q [B, H, D], pools [N, bs, Hkv, D], block_tables [B, M] int32,
    lengths [B] int32 -> [B, H, D]."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   lengths)
    if q.is_meta:
        return _pa.paged_attention_meta(q, k_pages, v_pages, block_tables,
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
    if x.is_meta:
        return _ss.selective_scan_meta(dt, x, b, c, a, h0)
    return _ss.selective_scan(dt, x, b, c, a, h0)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel name."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def variant_launch_counts() -> Dict[str, Dict[str, int]]:
    """Launches so far by variant, for the kernels that have variants."""
    return {name: dict(fn.variant_launches) for name, fn in WRAPPERS.items()
            if hasattr(fn, "variant_launches")}


def reset_launch_counts() -> None:
    """Zero every kernel's launch count and its variants' counts."""
    for fn in WRAPPERS.values():
        fn.launches = 0
        for variant in getattr(fn, "variant_launches", {}):
            fn.variant_launches[variant] = 0


__all__ = ["WRAPPERS", "flash_attention", "flash_attention_ref",
           "launch_counts", "matmul_tiled", "matmul_tiled_ref",
           "multi_add", "multi_add_ref", "on_card_route", "paged_attention",
           "paged_attention_ref", "reset_launch_counts", "selective_scan",
           "selective_scan_ref", "variant_launch_counts"]
