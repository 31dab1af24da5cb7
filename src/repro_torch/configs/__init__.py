"""Architecture registry: ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeSpec,
                                cell_is_runnable)

_MODULES = {
    "arctic-480b": "arctic_480b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "whisper-medium": "whisper_medium",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "yi-34b": "yi_34b",
    "minicpm-2b": "minicpm_2b",
    "llava-next-34b": "llava_next_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get_config(name) for name in list_archs()}


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "cell_is_runnable",
           "get_config", "all_configs", "list_archs"]
