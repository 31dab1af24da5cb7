"""Optimizer of the port (counterpart of ``repro/optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply_updates,
                                     global_norm, init_state, lr_at)

__all__ = ["AdamWConfig", "AdamWState", "apply_updates", "global_norm",
           "init_state", "lr_at"]
