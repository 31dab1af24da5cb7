"""Weights from the JAX package's parameter tree into the port's layout.

The reference stacks every layer's weights into ``[L, ...]`` arrays for
``lax.scan``; the port keeps a list of per-layer dictionaries.  The
input is the reference tree with its leaves already converted to numpy
(``jax.tree.map(np.asarray, params)``), so this module imports nothing
of JAX.  bfloat16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses: they go through a ``uint16`` view and are
reinterpreted as ``torch.bfloat16``, bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import INIT_FAMILIES, Params


def tensor_from_numpy(arr: np.ndarray, device: torch.device
                      ) -> torch.Tensor:
    """A numpy array (bfloat16 included) as a tensor on ``device``."""
    arr = np.array(arr, order="C")      # a writable copy the tensor owns
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig,
                    device: DeviceLike = None) -> Params:
    """The reference's dense-decoder or SSM parameter tree (numpy leaves)
    as the port's parameters on ``device`` (default ``cuda``).  Each
    leaf keeps its dtype: the SSM's float32 ``a_log`` and ``d_skip`` stay
    float32 in a bfloat16 model."""
    if cfg.family not in INIT_FAMILIES:
        raise NotImplementedError(
            f"params_from_jax: the port covers families {INIT_FAMILIES}, "
            f"not {cfg.family!r}")
    dev = resolve_device(device)
    out: Params = {name: tensor_from_numpy(tree[name], dev)
                   for name in ("embed", "ln_f", "head")}
    stacked = tree["layers"]
    out["layers"] = [
        {name: tensor_from_numpy(arr[i], dev)
         for name, arr in stacked.items()}
        for i in range(cfg.num_layers)]
    return out


__all__ = ["params_from_jax", "tensor_from_numpy"]
