"""Architecture + shape configuration system.

One ``ArchConfig`` per assigned architecture (exact values from the
assignment table), plus a ``reduced()`` transform used by the CPU smoke
tests.  ``ShapeSpec`` defines the four assigned input shapes; helpers
decide which (arch x shape) cells are runnable (long_500k only for
sub-quadratic decode families, per the assignment rules -- see DESIGN.md
Arch-applicability).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_dense_ff: int = 0         # Arctic-style parallel dense residual FFN
    capacity_factor: float = 1.25
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    # --- hybrid (RecurrentGemma) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rglru", "rglru", "local")
    local_window: int = 2048
    # --- encoder-decoder (Whisper backbone) ---
    encoder_layers: int = 0        # 0 -> decoder-only
    # --- modality frontend stub ---
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_tokens: int = 0        # soft tokens prepended (vision)
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""
    # --- perf levers (hillclimb knobs; defaults = paper-faithful
    # baseline) ---
    attn_probs_bf16: bool = False   # PV matmul on bf16 probabilities
    logits_bf16: bool = False       # lm head output in bf16 (CE upcasts)
    moe_shardmap_ep: bool = True    # explicit shard_map EP dispatch
                                    # (False = GSPMD-resolved scatter/
                                    # gather; kept for §Perf baselines)
    moe_ep: bool = False            # true expert parallelism: tokens
                                    # sharded over the EP axes, dispatch/
                                    # combine as explicit all-to-all
                                    # (models/moe_ep.py)
    moe_ep_algorithm: str = "auto"  # exchange backend: "lax" (bare
                                    # single-shot) or an engine
                                    # algorithm/plan shape ("auto",
                                    # "hierarchical", "ring", ...)
    fused_tp: bool = False          # TP down-projection psum decomposed
                                    # as reduce-scatter + allgather with
                                    # the RS fused into the GEMM ring
                                    # (shardmap_impl.fused_matmul_rs);
                                    # launchers also flip the module
                                    # switch via layers.set_fused_tp
    remat_policy: str = "full"      # full | dots | dots_no_batch
    grad_barrier: bool = False      # optimization_barrier on block-input
                                    # cotangents (keeps TP grad
                                    # all-reduces in bf16)
    sp_residuals: bool = False      # sequence-parallel residual stream:
                                    # shard saved layer inputs over
                                    # 'model' (Megatron SP); cuts remat-
                                    # saved activation memory ~TP-fold

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        if self.num_heads == 0:
            return 0
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context_decode(self) -> bool:
        """Constant-state decode: SSM and hybrid (RG-LRU + local window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def activation_dtype(self):
        return (torch.bfloat16 if self.dtype == "bfloat16"
                else torch.float32)

    # ------------------------------------------------------------------ #
    # analytic parameter counts (for MODEL_FLOPS in the roofline)
    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d
        head = d * self.vocab_size
        per_layer = 0
        if self.family == "ssm":
            di, n, r = self.d_inner, self.ssm_state, self.dt_rank
            per_layer = (d * 2 * di            # in_proj
                         + self.ssm_conv * di  # conv
                         + di * (r + 2 * n)    # x_proj
                         + r * di + di         # dt_proj
                         + di * n + di         # A_log, D
                         + di * d              # out_proj
                         + d)                  # norm
            return emb + head + self.num_layers * per_layer + d
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        dense_mlp = 3 * d * self.d_ff
        norms = 2 * d
        if self.family == "moe":
            router = d * self.num_experts
            experts = self.num_experts * 3 * d * self.d_ff
            dense_res = 3 * d * self.moe_dense_ff if self.moe_dense_ff else 0
            per_layer = attn + router + experts + dense_res + norms
        elif self.family == "hybrid":
            total = 0
            lru = d
            gate_block = lru // max(self.num_heads, 1)
            for i in range(self.num_layers):
                kind = self.block_pattern[i % len(self.block_pattern)]
                mlp = 3 * d * self.d_ff
                if kind == "local":
                    total += attn + mlp + norms
                else:  # RG-LRU recurrent block (Griffin)
                    total += (2 * d * lru                 # two input branches
                              + self.ssm_conv * lru       # temporal conv
                              + 2 * lru * gate_block      # block-diag a/i gates
                              + lru                       # Lambda
                              + lru * d                   # out proj
                              + mlp + norms)
            return emb + head + total + d
        elif self.family == "encdec":
            # encoder self-attn + mlp; decoder self-attn + cross-attn + mlp
            enc = self.encoder_layers * (attn + dense_mlp + norms)
            dec = self.num_layers * (2 * attn + dense_mlp + 3 * d)
            return emb + head + enc + dec + 2 * d
        else:
            per_layer = attn + dense_mlp + norms
        return emb + head + self.num_layers * per_layer + d

    def active_param_count(self) -> int:
        """Parameters touched per token (= param_count for non-MoE)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        hd = self.resolved_head_dim
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        router = d * self.num_experts
        experts_active = self.experts_per_token * 3 * d * self.d_ff
        dense_res = 3 * d * self.moe_dense_ff if self.moe_dense_ff else 0
        per_layer = attn + router + experts_active + dense_res + 2 * d
        return (self.vocab_size * d * 2 + self.num_layers * per_layer + d)

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pattern = self.block_pattern or ()
        n_layers = len(pattern) if pattern else 2
        kv = min(self.num_kv_heads, 2) if self.num_kv_heads else 0
        heads = 4 if self.num_heads else 0
        if self.num_kv_heads == self.num_heads:
            kv = heads
        elif self.num_kv_heads == 1:
            kv = 1
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16 if heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_dense_ff=64 if self.moe_dense_ff else 0,
            ssm_state=min(self.ssm_state, 8),
            local_window=32,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=8 if self.frontend_tokens else 0,
        )


def layer_units(cfg: ArchConfig) -> int:
    """Number of homogeneous layer-units for cost extrapolation: pattern
    cycles for hybrids, enc+dec pairs for enc-dec, layers otherwise."""
    if cfg.family == "hybrid":
        cyc = len(cfg.block_pattern)
        return cfg.num_layers // cyc
    return cfg.num_layers


def with_layer_units(cfg: ArchConfig, units: int) -> ArchConfig:
    """Same architecture with ``units`` layer-units (keeps the hybrid
    tail remainder so the unit slope is exact)."""
    if cfg.family == "hybrid":
        cyc = len(cfg.block_pattern)
        rem = cfg.num_layers % cyc
        return dataclasses.replace(cfg, num_layers=units * cyc + rem)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=units,
                                   encoder_layers=units)
    return dataclasses.replace(cfg, num_layers=units)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic decode archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context_decode:
        return False, ("skipped: pure full-attention arch cannot serve 524k "
                       "context (quadratic attention); per assignment rule")
    return True, ""


__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "cell_is_runnable",
           "layer_units", "with_layer_units"]
