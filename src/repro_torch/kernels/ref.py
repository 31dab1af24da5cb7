"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written kernel computes, with the
same algorithm as the reference oracle of the same name in
``repro/kernels/ref.py``.  The CPU path of ``repro_torch.kernels.ops``
runs these; on the GPU they are the yardstick the kernels are held
against.
"""

from __future__ import annotations

from typing import Tuple

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Block-indexed decode attention over a paged KV cache.

    ``q``: [B, H, D] single-position queries; ``k_pages``/``v_pages``:
    [N, bs, Hkv, D] physical block pool; ``block_tables``: [B, M] int32
    per-request block ids (logical order); ``lengths``: [B] int32 valid
    context per request.  Returns [B, H, D].  Supports GQA.  A row of
    length 0 is all-masked and gives NaN, as the reference oracle does.
    """
    n, bs, hkv, d = k_pages.shape
    b, h, _ = q.shape
    m = block_tables.shape[1]
    group = h // hkv
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=q.device)[None, None, :]
           ).reshape(b, m * bs)
    k = k_pages.reshape(n * bs, hkv, d)[idx]           # [B, S, Hkv, D]
    v = v_pages.reshape(n * bs, hkv, d)[idx]
    kf = k.transpose(1, 2).float().repeat_interleave(group, dim=1)
    vf = v.transpose(1, 2).float().repeat_interleave(group, dim=1)
    qf = q.float() / (d ** 0.5)
    logits = torch.einsum("bhd,bhkd->bhk", qf, kf)
    mask = (torch.arange(m * bs, device=q.device)[None, None, :]
            < lengths[:, None, None])
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs, vf)
    return out.to(q.dtype)


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan as the plain sequential recurrence
    (float32 throughout)::

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
        y_t = <h_t, C_t>

    dt/x: [B, S, D]; b/c: [B, S, N]; a: [D, N]; h0: [B, D, N].  Returns
    (y [B, S, D] in x.dtype, h_final [B, D, N] float32).  The plain
    version of all three scan kernels: its gradient, by autograd, is what
    the backward kernel computes."""
    dt32, x32, b32, c32 = (t.float() for t in (dt, x, b, c))
    a32 = a.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        a_bar = torch.exp(dt32[:, t, :, None] * a32)           # [B, D, N]
        b_bar = (dt32[:, t] * x32[:, t])[:, :, None] * b32[:, t, None, :]
        h = a_bar * h + b_bar
        ys.append((h * c32[:, t, None, :]).sum(-1))           # [B, D]
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros(x.shape)
    return y.to(x.dtype), h


__all__ = ["paged_attention_ref", "selective_scan_ref"]
