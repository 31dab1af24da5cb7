"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W limit) and the work of the calls the per-layer
metrics judge, counted from shapes.

``flash_bound_s`` is the rule of ``chip_smoke.py``'s ``flash_bound``
(copied, not imported): inputs read once and outputs written once at the
HBM rate, operations at the dtype's tensor-core rate, the larger of the
two times is the least time the call could take.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12,
                  "float32": 67e12}
#: the bf16 dense tensor-core peak every MFU is taken against
PEAK_BF16 = PEAK_OPS_PER_S["bfloat16"]

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def causal_pairs(s: int) -> int:
    """(query, key) pairs of one head that a causal mask keeps."""
    return s * (s + 1) // 2


def flash_bound_s(b: int, h: int, hkv: int, s: int, d: int,
                  dtype: str = "bfloat16", causal: bool = True) -> float:
    """Least seconds of one flash forward call: 4 d operations per kept
    (query, key) pair and query head; q, k, v read once, o and the
    float32 log-sum-exp written once."""
    pairs = causal_pairs(s) if causal else s * s
    ops = 4 * d * pairs * b * h
    esize = ESIZE[dtype]
    nbytes = (2 * b * h * s * d + 2 * b * hkv * s * d) * esize + 4 * b * h * s
    return max(ops / PEAK_OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)


def matmul_params(arch: dict) -> int:
    """Parameters that a token multiplies in one forward pass of a dense
    decoder: the attention projections, the FFN and the output head.
    The embedding is a lookup and the norms are elementwise."""
    d, h, kv = arch["d_model"], arch["num_heads"], arch["num_kv_heads"]
    hd = arch.get("head_dim") or d // h
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    ffn = 3 * d * arch["d_ff"]
    return arch["num_layers"] * (attn + ffn) + d * arch["vocab_size"]


def attention_flops(arch: dict, context: int) -> int:
    """Forward operations of one token's attention over ``context``
    positions (itself included), over every layer: Q K^T and P V."""
    d, h = arch["d_model"], arch["num_heads"]
    hd = arch.get("head_dim") or d // h
    return 4 * arch["num_layers"] * h * hd * context


def train_flops_per_step(arch: dict, rows: int, seq: int) -> int:
    """Model operations of one training step (forward and backward, no
    recompute): 6 per matmul parameter per token, and 3 times the causal
    attention forward."""
    attn = 3 * rows * attention_flops(arch, 1) * causal_pairs(seq)
    return 6 * matmul_params(arch) * rows * seq + attn
