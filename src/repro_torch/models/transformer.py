"""Dense decoder parameters, embedding, unembedding and the FFN
sublayer (the parts of ``repro/models/transformer.py`` the paged
serving path runs).

Parameters are a plain dictionary, as the reference's pytree, except
that the layer stack is a Python list of per-layer dictionaries instead
of ``[L, ...]`` arrays stacked for ``lax.scan``::

    {"embed": [V, D], "ln_f": [D], "head": [D, V],
     "layers": [{"ln1", "ln2", "wq", "wk", "wv", "wo",
                 "wg", "wu", "wd"}, ...]}

MoE, SSM, hybrid and encoder-decoder families are later slices.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import rms_norm, swiglu

Params = Dict[str, Any]


def _norm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


def _dense(gen: torch.Generator, shape, scale: float, dtype
           ) -> torch.Tensor:
    # float32 normals scaled, then cast: the reference's recipe
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _decoder_layer(gen: torch.Generator, cfg: ArchConfig, dtype) -> Params:
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    s = d ** -0.5
    return {
        "ln1": _norm(d, dtype, gen.device),
        "ln2": _norm(d, dtype, gen.device),
        "wq": _dense(gen, (d, h * hd), s, dtype),
        "wk": _dense(gen, (d, kv * hd), s, dtype),
        "wv": _dense(gen, (d, kv * hd), s, dtype),
        "wo": _dense(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
        "wg": _dense(gen, (d, f), s, dtype),
        "wu": _dense(gen, (d, f), s, dtype),
        "wd": _dense(gen, (f, d), f ** -0.5, dtype),
    }


def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random dense-decoder weights, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (default ``cuda``).  Shapes and
    scales follow the reference; norm weights start at zero.  The draws
    differ from ``jax.random``'s: to hold the port against the reference
    on the same weights, convert them with
    ``repro_torch.convert.params_from_jax``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"init_params: the port covers the dense family, not "
            f"{cfg.family!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = cfg.activation_dtype
    d, v = cfg.d_model, cfg.vocab_size
    params: Params = {
        "embed": _dense(gen, (v, d), 1.0, dtype),
        "ln_f": _norm(d, dtype, dev),
        "head": _dense(gen, (d, v), d ** -0.5, dtype),
    }
    params["layers"] = [_decoder_layer(gen, cfg, dtype)
                        for _ in range(cfg.num_layers)]
    return params


def _embed(params: Params, cfg: ArchConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    # the sqrt(d_model) scale is rounded to the activation dtype first
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x * scale


def _unembed(params: Params, cfg: ArchConfig,
             x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    # head matmul in the activation dtype, then the cast (inputs are not
    # upcast first)
    out_dtype = torch.bfloat16 if cfg.logits_bf16 else torch.float32
    return (x @ params["head"]).to(out_dtype)


def _ffn_sublayer(cfg: ArchConfig, x: torch.Tensor,
                  p: Params) -> torch.Tensor:
    """Dense SwiGLU FFN (the MoE branch is a later slice)."""
    return swiglu(x, p["wg"], p["wu"], p["wd"])


__all__ = ["Params", "init_params"]
