"""A plain decoder: the published architecture as the configuration file
states it, in float32 with TF32 off.

Pre-norm blocks: ``x + attn(norm(x))``, then ``x + ffn(norm(x))``; RMS
norm scaled by ``1 + w``; rotary embeddings on the two halves of each
head; causal softmax attention; a SwiGLU FFN; the token embeddings
scaled by ``sqrt(d_model)``; a final norm and an untied output head.

``precision="fp8"`` is the control: every linear layer's operands
rounded to float8 e4m3 with one scale a tensor (gradients to e5m2 in
the backward), the products summed in float32, the step below the
bf16 that the configurations state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """Float32 matrix products without TF32."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ---------------------------------------------------------------------- #
# linear layers, in float32 or in the fp8 control
# ---------------------------------------------------------------------- #
def quantize(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8 type) with one scale for the
    tensor, its amax at the type's largest value; returned in float32."""
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq = quantize(x, torch.float8_e4m3fn)
        wq = quantize(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = quantize(g, torch.float8_e5m2)
        gx = gq @ wq.transpose(-1, -2)
        gw = (xq.reshape(-1, xq.shape[-1]).transpose(0, 1)
              @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return x @ w
    if precision == "fp8":
        return _Fp8Linear.apply(x, w)
    raise ValueError(f"unknown precision {precision!r}")


# ---------------------------------------------------------------------- #
# the block
# ---------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [B, T, H, D]: the first and second halves of each head rotated
    by the angle ``position * theta ** (-2 i / D)``."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float64) / d)
    ang = (positions.to(torch.float64)[:, None] * inv[None, :]).float()
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_block: int = 1024) -> torch.Tensor:
    """q [B, T, H, D], k/v [B, T, Hkv, D] -> [B, T, H, D]; query blocks
    of ``q_block``, each over the keys up to its end."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(g, dim=1)
    outs = []
    for s0 in range(0, t, q_block):
        s1 = min(s0 + q_block, t)
        scores = (qt[:, :, s0:s1] @ kt[:, :, :s1].transpose(-1, -2)
                  ) / math.sqrt(d)
        qi = torch.arange(s0, s1, device=q.device)[:, None]
        ki = torch.arange(s1, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
        outs.append(torch.softmax(scores, dim=-1) @ vt[:, :, :s1])
    return torch.cat(outs, dim=2).transpose(1, 2)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, precision: str) -> torch.Tensor:
    return linear(F.silu(linear(x, wg, precision)) * linear(x, wu, precision),
                  wd, precision)


def block(x: torch.Tensor, lp: Params, arch: dict, precision: str
          ) -> torch.Tensor:
    """One decoder layer over x [B, T, D] at positions 0 .. T - 1."""
    b, t, d = x.shape
    h, kv = arch["num_heads"], arch["num_kv_heads"]
    hd = arch.get("head_dim") or d // h
    eps, theta = arch["norm_eps"], arch["rope_theta"]
    pos = torch.arange(t, device=x.device)
    hn = rms_norm(x, lp["ln1"], eps)
    q = rope(linear(hn, lp["wq"], precision).view(b, t, h, hd), pos, theta)
    k = rope(linear(hn, lp["wk"], precision).view(b, t, kv, hd), pos, theta)
    v = linear(hn, lp["wv"], precision).view(b, t, kv, hd)
    x = x + linear(causal_attention(q, k, v).reshape(b, t, h * hd),
                   lp["wo"], precision)
    hn = rms_norm(x, lp["ln2"], eps)
    return x + swiglu(hn, lp["wg"], lp["wu"], lp["wd"], precision)


def embed(params: Params, arch: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens] * math.sqrt(arch["d_model"])


# ---------------------------------------------------------------------- #
# training: loss, gradients and AdamW
# ---------------------------------------------------------------------- #
def _loss_chunk(x: torch.Tensor, labels: torch.Tensor, ln_f, head,
                eps: float, precision: str) -> torch.Tensor:
    logits = linear(rms_norm(x, ln_f, eps), head, precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), reduction="sum")


def loss_and_grads(params: Params, arch: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, precision: str = "fp32",
                   seq_block: int = 1024
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over every position of the batch
    and the gradient of every leaf, by name; each layer recomputed in
    the backward, the loss in blocks of positions."""
    names, leaves = flat_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        with strict_fp32():
            x = embed(params, arch, tokens)
            for lp in params["layers"]:
                x = checkpoint(block, x, lp, arch, precision,
                               use_reentrant=False)
            total = x.new_zeros(())
            for s0 in range(0, tokens.shape[1], seq_block):
                total = total + checkpoint(
                    _loss_chunk, x[:, s0:s0 + seq_block],
                    labels[:, s0:s0 + seq_block], params["ln_f"],
                    params["head"], arch["norm_eps"], precision,
                    use_reentrant=False)
            loss = total / labels.numel()
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    return float(loss.detach()), dict(zip(names, grads))


def flat_leaves(params: Params) -> Tuple[List[str], List[torch.Tensor]]:
    """Leaf names (``layers.3.wq`` style) and leaves, names sorted within
    each dict."""
    names, leaves = [], []
    for key in sorted(params):
        if key == "layers":
            for i, lp in enumerate(params["layers"]):
                for name in sorted(lp):
                    names.append(f"layers.{i}.{name}")
                    leaves.append(lp[name])
        else:
            names.append(key)
            leaves.append(params[key])
    return names, leaves


def lr_at(opt: dict, count: int) -> float:
    """Warm-up, then the warmup-stable-decay schedule."""
    warm = min(count / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((count - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    if opt["schedule"] != "wsd":
        raise ValueError(f"schedule {opt['schedule']!r} is not the "
                         f"reference's")
    in_decay = min(max((t - (1 - opt["decay_fraction"]))
                       / opt["decay_fraction"], 0.0), 1.0)
    return opt["lr"] * warm * (1 - (1 - opt["min_lr_ratio"]) * in_decay)


class AdamW:
    """AdamW with the global-norm clip and decoupled weight decay on the
    matrices (every leaf of a layer, and the embedding and head; not the
    final norm), float32 state."""

    def __init__(self, params: Params, opt: dict):
        self.opt = opt
        self.names, self.leaves = flat_leaves(params)
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> float:
        """Apply one step; returns the gradient's global norm."""
        o = self.opt
        self.count += 1
        gs = [grads[n] for n in self.names]
        gnorm = float(torch.sqrt(sum(g.double().square().sum()
                                     for g in gs)))
        scale = min(1.0, o["grad_clip"] / (gnorm + 1e-9))
        lr = lr_at(o, self.count)
        b1c = 1 - o["b1"] ** self.count
        b2c = 1 - o["b2"] ** self.count
        with torch.no_grad():
            for name, p, g, m, v in zip(self.names, self.leaves, gs,
                                        self.m, self.v):
                g = g * scale
                m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
                v.mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
                upd = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
                if name != "ln_f":
                    upd = upd + o["weight_decay"] * p
                p.sub_(lr * upd)
        return gnorm
