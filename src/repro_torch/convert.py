"""Weights from the JAX package's parameter tree into the port's layout.

The reference stacks every layer's weights into ``[L, ...]`` arrays for
``lax.scan``; the port keeps a list of per-layer dictionaries (the
hybrid's ``cycles["b{j}"]`` ``[n_cycles, ...]`` arrays become lists of
per-cycle dictionaries, and its unstacked ``tail`` list a tuple; the
encoder-decoder's ``encoder`` and ``layers`` stacks become lists too).  The
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
                    device: DeviceLike = None, grid=None,
                    policy=None) -> Params:
    """The reference's parameter tree of any family (numpy leaves) as the
    port's parameters on ``device`` (default ``cuda``), every ``[L, ...]``
    leaf unstacked into the per-layer dictionaries (the MoE ``router``,
    ``eg``, ``eu``, ``ed`` and the nested ``dense_mlp`` too; the hybrid's
    ``[n_cycles, ...]`` leaves into per-cycle ones; the encoder-decoder's
    ``encoder`` and ``layers``, its ``enc_ln_f`` staying a leaf).
    Each leaf keeps its dtype: the SSM's float32 ``a_log`` and ``d_skip``,
    the MoE's float32 router and the RG-LRU's float32 ``lam`` stay
    float32 in a bfloat16 model.  With ``grid`` (this rank's ``GridComm``,
    and a ``ShardingPolicy`` or None) the tree comes across as the rank's
    shards over the grid's model axis (``sharding.rules.shard_params``),
    each a tensor of its own; ``sharding.rules.unshard_params`` of every
    rank's gives the whole tree back exactly."""
    if grid is not None:
        from repro_torch.sharding.rules import shard_params
        from repro_torch.tree import tree_map

        whole = params_from_jax(tree, cfg, device="cpu")
        dev = resolve_device(device)
        return tree_map(
            lambda x: x.to(dev, memory_format=torch.contiguous_format,
                           copy=True),
            shard_params(whole, cfg, grid, policy))
    if cfg.family not in INIT_FAMILIES:
        raise ValueError(f"params_from_jax: unknown family {cfg.family!r}")
    dev = resolve_device(device)
    out: Params = {name: tensor_from_numpy(tree[name], dev)
                   for name in ("embed", "ln_f", "head")}

    def layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
        return {name: (layer(arr, i) if isinstance(arr, dict)
                       else tensor_from_numpy(arr[i], dev))
                for name, arr in stacked.items()}

    if cfg.family == "hybrid":
        cycles = tree["cycles"]
        n_cycles = cfg.num_layers // len(cfg.block_pattern)
        out["cycles"] = {name: [layer(stacked, c) for c in range(n_cycles)]
                         for name, stacked in cycles.items()}
        out["tail"] = tuple({name: tensor_from_numpy(arr, dev)
                             for name, arr in block.items()}
                            for block in tree["tail"])
        return out
    if cfg.family == "encdec":
        out["encoder"] = [layer(tree["encoder"], i)
                          for i in range(cfg.encoder_layers)]
        out["enc_ln_f"] = tensor_from_numpy(tree["enc_ln_f"], dev)
    out["layers"] = [layer(tree["layers"], i)
                     for i in range(cfg.num_layers)]
    return out


__all__ = ["params_from_jax", "tensor_from_numpy"]
