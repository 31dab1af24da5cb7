"""Train state (counterpart of ``repro/train/state.py``).  The sharding
helpers wait for the multi-rank slice (ROADMAP A.3)."""

from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.optim.adamw import AdamWState, init_state


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(params: Any, master_weights: bool = False
                     ) -> TrainState:
    return TrainState(params=params, opt=init_state(params, master_weights))


__all__ = ["TrainState", "init_train_state"]
