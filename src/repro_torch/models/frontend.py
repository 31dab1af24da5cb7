"""Modality frontend stubs (counterpart of ``repro/models/frontend.py``).

The audio and vision configs specify the transformer backbone only; the
modality frontend is a stub whose outputs -- precomputed frame or patch
embeddings -- are drawn here, for the CLIs and the smoke run.  The
draws come from an explicit ``torch.Generator``: ``jax.random`` cannot be
reproduced in torch (ROADMAP C3), so the tests feed the same numpy
frames and soft tokens to both packages instead.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device


def _normal(gen: torch.Generator, shape, cfg: ArchConfig,
            device: DeviceLike) -> torch.Tensor:
    dev = resolve_device(device)
    x = torch.randn(shape, generator=gen, device=gen.device) * 0.02
    return x.to(device=dev, dtype=cfg.activation_dtype)


def audio_frames(gen: torch.Generator, cfg: ArchConfig, batch: int,
                 seq_len: int, device: DeviceLike = None) -> torch.Tensor:
    """Stub for Whisper's conv1d-over-mel frontend: [B, S, D] frame
    embeddings, 0.02 * standard normal in the activation dtype."""
    return _normal(gen, (batch, seq_len, cfg.d_model), cfg, device)


def vision_patches(gen: torch.Generator, cfg: ArchConfig, batch: int,
                   device: DeviceLike = None) -> torch.Tensor:
    """Stub for LLaVA-NeXT's anyres tiling + projector: [B, T_img, D]
    soft-token embeddings (T_img = ``cfg.frontend_tokens``), 0.02 *
    standard normal in the activation dtype."""
    return _normal(gen, (batch, cfg.frontend_tokens, cfg.d_model), cfg,
                   device)


__all__ = ["audio_frames", "vision_patches"]
