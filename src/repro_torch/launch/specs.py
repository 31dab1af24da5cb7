"""Meta-tensor stand-ins for every model input, per (arch x shape): the
counterpart of ``repro/launch/specs.py``'s ``jax.ShapeDtypeStruct`` s.

The dry-run (``launch.dryrun``) runs one rank's step on these: the
names, shapes and dtypes of the reference's, with nothing allocated.
``step_kind`` decides what a cell runs:

  train_4k      -> train_step(state, batch)
  prefill_32k   -> prefill(params, batch)
  decode_32k / long_500k -> decode_step(params, cache, batch)

Whisper conventions (the reference's backbone-only spec): prefill runs
the encoder over ``seq_len`` frames with a 448-token decoder prompt;
decode uses a ``seq_len`` self-attention cache and a 1500-frame cross
cache.

A rank of a grid holds its rows of each: the batch dim cut over the DP
axes that divide it (``sharding.rules.batch_sharding_specs``, so
``long_500k``'s one row stays whole on every rank), and a decode cache
of those rows at the rank's kv heads, SSM channels or RG-LRU width
(``transformer.init_cache(..., tp=m)``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as tf
from repro_torch.sharding import rules

WHISPER_DECODER_PROMPT = 448
WHISPER_DECODE_CROSS_LEN = 1500

Specs = Dict[str, torch.Tensor]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_spec(b: int, s: int) -> torch.Tensor:
    return _meta((b, s), torch.int32)


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Specs:
    b, s = shape.global_batch, shape.seq_len
    specs: Specs = {}
    if cfg.frontend == "vision":
        n_img = cfg.frontend_tokens
        specs["soft_emb"] = _meta((b, n_img, cfg.d_model),
                                  cfg.activation_dtype)
        s_text = s - n_img
    else:
        s_text = s
    specs["tokens"] = _token_spec(b, s_text)
    specs["labels"] = _token_spec(b, s_text)
    if cfg.family == "encdec":
        specs["frames"] = _meta((b, s, cfg.d_model), cfg.activation_dtype)
    return specs


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Specs:
    b, s = shape.global_batch, shape.seq_len
    specs: Specs = {}
    if cfg.family == "encdec":
        specs["frames"] = _meta((b, s, cfg.d_model), cfg.activation_dtype)
        specs["tokens"] = _token_spec(b, WHISPER_DECODER_PROMPT)
        return specs
    if cfg.frontend == "vision":
        n_img = cfg.frontend_tokens
        specs["soft_emb"] = _meta((b, n_img, cfg.d_model),
                                  cfg.activation_dtype)
        specs["tokens"] = _token_spec(b, s - n_img)
        return specs
    specs["tokens"] = _token_spec(b, s)
    return specs


def decode_cache_specs(cfg: ArchConfig, shape: ShapeSpec, *, rows: int = 0,
                       tp: int = 1) -> Specs:
    """The decode cache of ``shape`` (``init_cache`` on the meta device;
    its "pos" is the CPU int32 scalar every cache carries); ``rows`` (0:
    the global batch) and ``tp`` give one rank's."""
    enc_len = WHISPER_DECODE_CROSS_LEN if cfg.family == "encdec" else 0
    return tf.init_cache(cfg, rows or shape.global_batch, shape.seq_len,
                         enc_len=enc_len, device="meta", tp=tp)


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Specs:
    return {"tokens": _token_spec(shape.global_batch, 1)}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Specs:
    """The batch stand-ins of ``shape``'s step."""
    if shape.step == "train":
        return train_input_specs(cfg, shape)
    if shape.step == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


def rank_rows(policy: rules.ShardingPolicy, batch: int) -> int:
    """A rank's rows of a ``batch``-row input: cut over the largest DP
    prefix that divides it, whole where none does."""
    dp = rules.batch_sharding_specs(
        policy, {"x": _meta((batch,), torch.int32)})["x"][0]
    return batch // policy.axis_size(dp)


def rank_batch_specs(policy: rules.ShardingPolicy, specs: Specs) -> Specs:
    """Each stand-in cut to a rank's rows (:func:`rank_rows`)."""
    return {k: _meta((rank_rows(policy, v.shape[0]),) + tuple(v.shape[1:]),
                     v.dtype) for k, v in specs.items()}


def rank_cache_specs(cfg: ArchConfig, shape: ShapeSpec,
                     policy: rules.ShardingPolicy) -> Specs:
    """A rank's decode cache: its rows, at its kv heads (or the one kv
    head its q heads use where they are fewer than the ranks, ROADMAP
    C31), SSM channels or RG-LRU width."""
    return decode_cache_specs(
        cfg, shape, rows=rank_rows(policy, shape.global_batch),
        tp=policy.axis_size(policy.model_axis))


__all__ = ["WHISPER_DECODER_PROMPT", "WHISPER_DECODE_CROSS_LEN",
           "decode_cache_specs", "decode_input_specs", "input_specs",
           "prefill_input_specs", "rank_batch_specs", "rank_cache_specs",
           "rank_rows", "train_input_specs"]
