"""Token sampling for the serving path: greedy / temperature / top-k
(counterpart of ``repro/serving/sampling.py``).

Greedy rows take the argmax (the first index on ties), bit for bit as
the reference does.  Stochastic rows keep the reference's contract --
the token is a pure function of ``(seed, sample_id, logits row)``,
never of slot placement -- but not its bits: ``jax.random`` cannot be
reproduced in torch.  The port draws by Gumbel-max over counter-based
noise: a 32-bit integer hash of ``(seed, sample_id, vocab index)``,
computed with integer tensor ops, gives the same noise bits on the CPU
and on the GPU.

``temperature <= 0`` means greedy, per row; ``top_k`` is per row too
(0 = full vocabulary).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration."""
    temperature: float = 0.0    # <= 0: greedy
    top_k: int = 0              # 0: server default (or full vocab)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash of int64 values in [0, 2^32).  Multipliers
    stay below 2^31, so no int64 product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, sample_ids: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, V] float32 standard Gumbel noise, a pure function of
    ``(seed, sample_ids[b], v)``."""
    dev = sample_ids.device
    key = _mix32(torch.tensor(seed & _M32, dtype=torch.int64, device=dev))
    row = _mix32(key ^ (sample_ids.long() & _M32))                  # [B]
    col = _mix32((torch.arange(vocab, dtype=torch.int64, device=dev)
                  + 0x9E3779B9) & _M32)                           # [V]
    bits = _mix32(row[:, None] ^ col[None, :])                   # [B, V]
    # 24 high bits -> u in (0, 1), exactly representable in float32
    u = ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, sample_ids: torch.Tensor,
                  temperatures: torch.Tensor, seed: int,
                  top_ks: Union[torch.Tensor, int] = 0) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32.

    Rows with temperature <= 0 take the argmax; others sample from
    softmax(logits / T) restricted to their top-k logits when their
    ``top_ks`` entry is > 0 (a scalar ``top_ks`` applies to every row).
    """
    logits = logits.float()
    b, v = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if isinstance(top_ks, int):
        top_ks = torch.full((b,), top_ks, dtype=torch.int32,
                            device=logits.device)
    k = torch.clamp(top_ks.long(), 0, v)
    if bool((k > 0).any()):
        # per-row k-th largest as the cutoff; k == 0 disables the filter
        ordered = torch.sort(logits, dim=-1).values            # ascending
        kth = torch.gather(ordered, 1, torch.clamp(v - k, max=v - 1)[:, None])
        kth = torch.where((k > 0)[:, None], kth,
                          torch.full_like(kth, float("-inf")))
        logits = logits.masked_fill(logits < kth, float("-inf"))
    scaled = logits / torch.clamp(temperatures.float(), min=1e-6)[:, None]
    noisy = scaled + gumbel_noise(seed, sample_ids, v)
    sampled = torch.argmax(noisy, dim=-1).to(torch.int32)
    return torch.where(temperatures > 0, sampled, greedy)


__all__ = ["SamplingParams", "gumbel_noise", "sample_tokens"]
