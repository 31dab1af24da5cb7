"""The run's surroundings: cache directories inside the checkout, the
device's description, and the check that nothing of JAX was loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

from perfbench.lib.manifest import ROOT

#: top-level module names no run may load (compared whole: the port's
#: own package, ``repro_torch``, begins with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: build and kernel caches of the program, at fixed paths inside the
#: checkout (``build/`` is where the port's nvcc libraries go too)
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/perfbench/torch_extensions",
    "TRITON_CACHE_DIR": "build/perfbench/triton",
    "REPRO_TORCH_CACHE_DIR": "build/perfbench/engine",
}


def setup_environment(root: Path = ROOT) -> None:
    """Fix the caches inside the checkout and keep libraries from
    loading JAX on their own (``transformers`` reads ``USE_FLAX``).
    Also puts the port's sources on the path."""
    for key, rel in CACHE_DIRS.items():
        path = root / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["REPRO_TORCH_RESTORE_TOPOLOGY"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that no run may load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why
    it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def device_record(count: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak_bytes)}
