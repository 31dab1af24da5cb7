"""Transformer primitives of the paged serving path: RMSNorm, rotary
embeddings and the SwiGLU MLP (counterparts of the functions with the
same names in ``repro/models/layers.py``).

Conventions kept from the reference:

* ``rms_norm`` computes in float32 and scales by ``(1 + weight)``, so a
  zero-initialised norm weight is the identity scale;
* RoPE is the half-split form: the first and second halves of the head
  dimension form the rotated pairs (not interleaved even/odd lanes).

The reference's sharding hints and its fused tensor-parallel
down-projection have no counterpart: the port runs one device per
process until the collective slices land.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S])."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs             # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


__all__ = ["rms_norm", "rope_frequencies", "apply_rope", "swiglu"]
