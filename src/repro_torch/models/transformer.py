"""Model parameters and entry points (counterpart of
``repro/models/transformer.py``): the dense decoder's parameters,
embedding, unembedding and FFN sublayer, which the paged serving path
runs (``models/paged.py``), and the Mamba SSM stack's three entry points

    forward_train(params, cfg, batch)              -> (logits, aux)
    prefill(params, cfg, batch)                    -> (logits, cache)
    decode_step(params, cfg, cache, batch)         -> (logits, cache)

Parameters are a plain dictionary, as the reference's pytree, except
that the layer stack is a Python list of per-layer dictionaries instead
of ``[L, ...]`` arrays stacked for ``lax.scan``::

    dense: {"embed": [V, D], "ln_f": [D], "head": [D, V],
            "layers": [{"ln1", "ln2", "wq", "wk", "wv", "wo",
                        "wg", "wu", "wd"}, ...]}
    ssm:   {"embed", "ln_f", "head",
            "layers": [{"ln", "in_proj", "conv_w", "x_proj", "dt_w",
                        "dt_b", "a_log", "d_skip", "out_proj"}, ...]}

Training the dense family waits for the dense trainer (ROADMAP.md A.3);
MoE, hybrid and encoder-decoder families are later slices too.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import ssm as ssm_lib
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


#: families whose parameters the port initialises
INIT_FAMILIES = ("dense", "ssm")


def _not_ported(fn: str, cfg: ArchConfig) -> NotImplementedError:
    later = {"dense": "the dense trainer (ROADMAP.md A.3)",
             "moe": "the MoE slice (ROADMAP.md A.4)",
             "hybrid": "the hybrid family (ROADMAP.md A.6)"}
    return NotImplementedError(
        f"{fn}: the port covers the ssm family here; {cfg.family!r} waits "
        f"for {later.get(cfg.family, 'a later slice (ROADMAP.md A)')}")


def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights of a dense decoder or a Mamba stack, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (default
    ``cuda``).  Shapes and scales follow the reference; norm weights
    start at zero.  The draws differ from ``jax.random``'s: to hold the
    port against the reference on the same weights, convert them with
    ``repro_torch.convert.params_from_jax``."""
    if cfg.family not in INIT_FAMILIES:
        raise NotImplementedError(
            f"init_params: the port covers families {INIT_FAMILIES}, not "
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
    if cfg.family == "ssm":
        params["layers"] = [
            {"ln": _norm(d, dtype, dev),
             **ssm_lib.init_mamba_params(gen, d, cfg.d_inner, cfg.ssm_state,
                                         cfg.dt_rank, cfg.ssm_conv, dtype)}
            for _ in range(cfg.num_layers)]
        return params
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


# ====================================================================== #
# the SSM stack: train / prefill / decode
# ====================================================================== #
def _ssm_layer(cfg: ArchConfig, h: torch.Tensor, lp: Params,
               use_kernel: bool,
               state: ssm_lib.SSMState | None = None,
               single_step: bool = False
               ) -> Tuple[torch.Tensor, ssm_lib.SSMState]:
    y, st = ssm_lib.mamba_block(rms_norm(h, lp["ln"], cfg.norm_eps), lp,
                                ssm_state=cfg.ssm_state, state=state,
                                single_step=single_step,
                                use_kernel=use_kernel)
    return h + y, st


def forward_train(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
                  remat: bool = True, use_kernel: bool = False
                  ) -> Tuple[torch.Tensor, float]:
    """Returns (logits [B, S, V], aux_loss).  ``remat`` checkpoints each
    layer (``torch.utils.checkpoint``, non-reentrant: the counterpart of
    ``jax.checkpoint`` with ``nothing_saveable``); ``use_kernel`` routes
    the scan through the fused kernel (``models/ssm.py``)."""
    if cfg.family != "ssm":
        raise _not_ported("forward_train", cfg)
    if batch.get("soft_emb") is not None:
        raise NotImplementedError("vision soft tokens are not ported yet")
    x = _embed(params, cfg, batch["tokens"])

    def layer(h, lp):
        return _ssm_layer(cfg, h, lp, use_kernel)[0]

    for lp in params["layers"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = layer(x, lp)
    return _unembed(params, cfg, x), 0.0


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            use_kernel: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward over a prompt, returning last-position logits [B, 1, V]
    and the decode cache {"conv": [L, B, K-1, di], "h": [L, B, di, N],
    "pos": int32 scalar}."""
    if cfg.family != "ssm":
        raise _not_ported("prefill", cfg)
    x = _embed(params, cfg, batch["tokens"])
    convs, hs = [], []
    for lp in params["layers"]:
        x, st = _ssm_layer(cfg, x, lp, use_kernel)
        convs.append(st.conv)
        hs.append(st.h)
    cache = {"conv": torch.stack(convs), "h": torch.stack(hs),
             "pos": torch.tensor(x.shape[1], dtype=torch.int32)}
    return _unembed(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ArchConfig,
                cache: Dict[str, torch.Tensor], batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  batch: {"tokens": [B, 1]}.  Returns (logits
    [B, 1, V], new cache).  The single-step arithmetic, no kernel, as in
    the reference."""
    if cfg.family != "ssm":
        raise _not_ported("decode_step", cfg)
    x = _embed(params, cfg, batch["tokens"])
    convs, hs = [], []
    for i, lp in enumerate(params["layers"]):
        st = ssm_lib.SSMState(conv=cache["conv"][i], h=cache["h"][i])
        x, st = _ssm_layer(cfg, x, lp, False, state=st, single_step=True)
        convs.append(st.conv)
        hs.append(st.h)
    new_cache = {"conv": torch.stack(convs), "h": torch.stack(hs),
                 "pos": cache["pos"] + 1}
    return _unembed(params, cfg, x), new_cache


__all__ = ["INIT_FAMILIES", "Params", "decode_step", "forward_train",
           "init_params", "prefill"]
