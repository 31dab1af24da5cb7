"""Chunked linear-recurrence scan (counterpart of
``repro/models/scan_utils.py``): the SSM block's plain route.

Computes h_t = a_t * h_{t-1} + b_t along the sequence axis by walking
fixed-size chunks in order and running a parallel prefix combine inside
each chunk, so the intermediates stay [B, chunk, ...] instead of
[B, S, ...] per doubling level.  Each chunk step is checkpointed, as the
reference's ``jax.checkpoint`` on its scan body.

The in-chunk prefix is the Hillis-Steele doubling scan (log2(chunk)
shifted combines); ``lax.associative_scan`` groups the same products
differently, so the two agree to float rounding, not bitwise.  A
sequence that is not a multiple of the chunk ends with a shorter chunk
(the reference asserts divisibility).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

DEFAULT_CHUNK = 128


def _prefix_combine(a: torch.Tensor, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix of (a, b) under (a_l, b_l) . (a_r, b_r) =
    (a_r a_l, a_r b_l + b_r) along axis 1."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_new = a.clone()
        b_new = b.clone()
        a_new[:, off:] = a[:, off:] * a[:, :-off]
        b_new[:, off:] = a[:, off:] * b[:, :-off] + b[:, off:]
        a, b = a_new, b_new
        off *= 2
    return a, b


def _chunk_step(h: torch.Tensor, a_i: torch.Tensor, b_i: torch.Tensor
                ) -> torch.Tensor:
    a_cum, b_cum = _prefix_combine(a_i, b_i)
    return a_cum * h[:, None] + b_cum


def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                        chunk: int = DEFAULT_CHUNK
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t along axis 1.

    a, b: [B, S, ...] (same shape); h0: [B, ...].
    Returns (h_all [B, S, ...], h_final [B, ...]).
    """
    s = a.shape[1]
    chunk = max(1, min(chunk, s))
    h = h0
    outs = []
    for start in range(0, s, chunk):
        a_i = a[:, start:start + chunk]
        b_i = b[:, start:start + chunk]
        if torch.is_grad_enabled() and (a_i.requires_grad
                                        or b_i.requires_grad
                                        or h.requires_grad):
            h_chunk = checkpoint(_chunk_step, h, a_i, b_i,
                                 use_reentrant=False)
        else:
            h_chunk = _chunk_step(h, a_i, b_i)
        outs.append(h_chunk)
        h = h_chunk[:, -1]
    return torch.cat(outs, dim=1), h


def linear_scan_step(a: torch.Tensor, b: torch.Tensor,
                     h: torch.Tensor) -> torch.Tensor:
    """Single decode step of the same recurrence."""
    return a * h + b


__all__ = ["chunked_linear_scan", "linear_scan_step", "DEFAULT_CHUNK"]
