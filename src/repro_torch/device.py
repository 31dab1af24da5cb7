"""Device selection for the port's entry points.

Every public entry point takes a ``device`` argument.  ``None`` means
``"cuda"``: the port targets the GPU, and a missing GPU is an error, not
a reason to carry on quietly on the CPU.  The CPU runs only when the
caller asks for it, as the tests do.  The meta device is taken only
where a dry-run needs it (:func:`resolve_or_meta`).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_or_meta(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device`, except that the meta device passes: shapes
    and dtypes with nothing allocated (the dry-run sizes a step so,
    ``repro_torch.launch.dryrun``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


__all__ = ["DeviceLike", "resolve_device", "resolve_or_meta"]
