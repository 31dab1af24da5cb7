"""Paged-KV-cache model entry points for continuous-batching serving
(counterpart of ``repro/models/paged.py``).

The physical cache is a pool of fixed-size blocks shared by every
request in the batch::

    pages = {"k": [L, N, bs, Hkv, Hd], "v": [L, N, bs, Hkv, Hd]}

Per-request state lives host-side in the serving scheduler and is passed
in per call: ``block_tables`` [B, M] int32 (pool indices in logical
order) and ``ctx_lens`` [B] int32 (tokens already cached).  Block 0 is
reserved as a scratch sink: writes from padded chunk tails and inactive
batch rows are redirected there, so idle decode slots never clobber live
cache state.

One forward handles both phases:

* **chunked prefill** -- ``forward_paged`` with T > 1 processes a chunk
  of the prompt with the plain gathered attention (as in the reference,
  where prefill is jnp and no Pallas kernel);
* **decode** -- T = 1; with ``use_kernel`` the attention runs the
  hand-written CUDA block-indexed kernel
  (``repro_torch.kernels.ops.paged_attention``), which reads only the
  blocks each request references.

Where the reference threads the pool through ``lax.scan`` and donates
it, the port writes each layer's new K/V **in place** into per-layer
views of the pool: ``forward_paged`` returns the same ``pages`` dict it
was given, updated.  The dense and MoE decoder families are covered,
vision configs with their soft tokens on a request's first prefill
chunk (they occupy cache positions like tokens, so decode needs nothing
more).  The MoE FFN groups tokens by
batch row, so a prefill chunk ``[1, chunk]`` and a decode step ``[B,
1]`` fill their experts' capacity as the reference's do at those shapes
(ROADMAP C18).

A tree of one rank's shards (``sharding.rules.shard_params``) runs under
an ambient grid with its "model" axis, as ``transformer``'s entry points:
its pool holds the rank's kv heads (``init_pages(..., tp=m)``), the
block attends on its heads (the paged kernel at the per-rank shape) and
reduces its two row-parallel outputs over "model"; the logits come back
whole.  Heads padded to the model axis are masked as in ``transformer``;
a tree cut over "data" is refused (the server has no model axis).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_or_meta
from repro_torch.kernels.ops import paged_attention
from repro_torch.models.layers import (_data_cut, apply_rope,
                                      copy_to_model, model_parallel,
                                      reduce_from_model, rms_norm)
from repro_torch.models.transformer import (Params, _embed, _ffn_sublayer,
                                           _kv_proj, _mask_pad_heads,
                                           _q_proj, _unembed, _whole_logits,
                                           local_kv_heads)

Pages = Dict[str, torch.Tensor]

PAGED_FAMILIES = ("dense", "moe")


def supports_paged(cfg: ArchConfig) -> bool:
    return cfg.family in PAGED_FAMILIES


def init_pages(cfg: ArchConfig, num_blocks: int, block_size: int,
               device: DeviceLike = None, tp: int = 1) -> Pages:
    """Zeroed physical block pool (block 0 is the scratch sink); ``tp``:
    one rank's pool of a model axis of that size (its kv heads);
    ``device="meta"`` gives the shapes only."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV cache covers families {PAGED_FAMILIES}, not "
            f"{cfg.family!r}")
    dev = resolve_or_meta(device)
    shape = (cfg.num_layers, num_blocks, block_size,
             local_kv_heads(cfg, tp), cfg.resolved_head_dim)
    dtype = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def copy_blocks(pages: Pages, src: torch.Tensor, dst: torch.Tensor) -> Pages:
    """Copy whole physical blocks ``src[i] -> dst[i]`` in every layer of
    the pool, in place (copy-on-write for shared prefix blocks).

    ``src``/``dst``: [n] pool indices; destinations must be distinct
    (they are freshly allocated), sources may repeat.  The sources are
    gathered before any destination is written.
    """
    src, dst = src.long(), dst.long()
    for arr in pages.values():
        arr[:, dst] = arr[:, src]
    return pages


def _write_pages(pages_l: torch.Tensor, new: torch.Tensor,
                 block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                 valid: torch.Tensor) -> None:
    """Scatter [B, T, Hkv, Hd] new KV into one layer's pool, in place.

    Position ctx+t of row b lands in slot (ctx+t) % bs of block
    block_tables[b, (ctx+t) // bs]; invalid positions (padded tails,
    inactive rows) are redirected into scratch block 0, where duplicate
    writes may land in any order.
    """
    n, bs = pages_l.shape[:2]
    b, t = new.shape[:2]
    m = block_tables.shape[1]
    pos = ctx_lens.long()[:, None] + torch.arange(t, device=new.device)
    blk = torch.gather(block_tables.long(), 1,
                       torch.clamp(pos // bs, max=m - 1))
    flat = torch.where(valid, blk * bs + pos % bs, pos % bs)
    pages_l.view(n * bs, *pages_l.shape[2:]).index_copy_(
        0, flat.reshape(-1),
        new.reshape(b * t, *new.shape[2:]).to(pages_l.dtype))


def _gathered_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        block_tables: torch.Tensor, ctx_lens: torch.Tensor
                        ) -> torch.Tensor:
    """Plain paged attention for T >= 1 (prefill chunks, CPU decode).

    q: [B, T, H, Hd] at absolute positions ctx..ctx+T-1; kp/vp:
    [N, bs, Hkv, Hd] pool *after* the chunk's writes.  Causal over the
    gathered logical context; scores and softmax in float32.
    """
    n, bs, hkv, hd = kp.shape
    b, t, h, _ = q.shape
    m = block_tables.shape[1]
    group = h // hkv
    dev = q.device
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=dev)[None, None, :]).reshape(b, m * bs)
    k = kp.reshape(n * bs, hkv, hd)[idx]                 # [B, S, Hkv, Hd]
    v = vp.reshape(n * bs, hkv, hd)[idx]
    kt = k.transpose(1, 2).repeat_interleave(group, dim=1)  # [B, H, S, Hd]
    vt = v.transpose(1, 2).repeat_interleave(group, dim=1)
    qt = q.transpose(1, 2)                               # [B, H, T, Hd]
    logits = torch.einsum("bhqd,bhkd->bhqk", qt.float(),
                          kt.float()) / (hd ** 0.5)
    q_pos = ctx_lens.long()[:, None] + torch.arange(t, device=dev)[None, :]
    k_pos = torch.arange(m * bs, device=dev)
    mask = k_pos[None, None, None, :] <= q_pos[:, None, :, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt.float())
    return out.to(q.dtype).transpose(1, 2)               # [B, T, H, Hd]


def _paged_decoder_block(cfg: ArchConfig, x: torch.Tensor, lp: Params,
                         kp: torch.Tensor, vp: torch.Tensor,
                         block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                         valid: torch.Tensor, use_kernel: bool
                         ) -> torch.Tensor:
    b, t, _ = x.shape
    hn = copy_to_model(rms_norm(x, lp["ln1"], cfg.norm_eps))
    q = _q_proj(cfg, hn, lp["wq"])
    k = _kv_proj(cfg, hn, lp["wk"])
    v = _kv_proj(cfg, hn, lp["wv"])
    h, hd = q.shape[2], q.shape[3]
    if k.shape[2] != kp.shape[2]:
        raise ValueError(f"a pool of {kp.shape[2]} kv heads for a block "
                         f"of {k.shape[2]} (init_pages(..., tp=))")
    pos = ctx_lens.long()[:, None] + torch.arange(t, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    # write the new K/V first, then attend over ctx + the new token(s)
    _write_pages(kp, k, block_tables, ctx_lens, valid)
    _write_pages(vp, v, block_tables, ctx_lens, valid)
    if t == 1 and use_kernel:
        out = paged_attention(q[:, 0].contiguous(), kp, vp, block_tables,
                              ctx_lens + 1)[:, None]
    else:
        out = _gathered_attention(q, kp, vp, block_tables, ctx_lens)
    out = _mask_pad_heads(cfg, out)
    x = x + reduce_from_model(out.reshape(b, t, h * hd) @ lp["wo"])
    f, _ = _ffn_sublayer(cfg, rms_norm(x, lp["ln2"], cfg.norm_eps), lp)
    return x + f


def forward_paged(params: Params, cfg: ArchConfig, pages: Pages,
                  batch: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                  ctx_lens: torch.Tensor,
                  new_lens: Optional[torch.Tensor] = None, *,
                  use_kernel: bool = False) -> Tuple[torch.Tensor, Pages]:
    """Run T new tokens per row against the paged cache.

    ``batch``: {"tokens": [B, T], optional "soft_emb": [B, n_soft, D]
    (vision, a request's first chunk only)}; ``block_tables`` [B, M] and
    ``ctx_lens`` [B] are int32; ``new_lens`` [B]: valid *token* positions
    this chunk (<= T; default all); soft positions are always valid when
    present.  Rows read and write positions ctx .. ctx + n_soft + T - 1,
    RoPE at those absolute positions.  Returns (logits [B, T, V] over the
    token positions, pages), the pool updated in place.  Invalid tail
    positions write to the scratch block and their logits are garbage the
    caller must ignore.  ``use_kernel`` routes T == 1 attention through
    the CUDA kernel (on CPU tensors the kernel's plain version runs
    instead).
    """
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"forward_paged: unsupported family {cfg.family!r}")
    with model_parallel(params, cfg):
        if _data_cut() is not None:
            raise NotImplementedError(
                "forward_paged: the paged route runs a tree whole over "
                "\"data\" (the server has no model axis, ROADMAP A)")
        logits, pages = _forward_paged(params, cfg, pages, batch,
                                       block_tables, ctx_lens, new_lens,
                                       use_kernel)
        return _whole_logits(cfg, logits), pages


def _forward_paged(params: Params, cfg: ArchConfig, pages: Pages,
                   batch: Dict[str, torch.Tensor], block_tables: torch.Tensor,
                   ctx_lens: torch.Tensor, new_lens: Optional[torch.Tensor],
                   use_kernel: bool) -> Tuple[torch.Tensor, Pages]:
    tokens = batch["tokens"]
    b, t = tokens.shape
    if new_lens is None:
        new_lens = torch.full((b,), t, dtype=torch.int32,
                              device=tokens.device)
    soft = batch.get("soft_emb")
    n_soft = 0 if soft is None else soft.shape[1]
    x = _embed(params, cfg, tokens, soft)
    valid = (torch.arange(t + n_soft, device=x.device)[None, :]
             < (new_lens + n_soft)[:, None])               # [B, T_eff]
    for i, lp in enumerate(params["layers"]):
        x = _paged_decoder_block(cfg, x, lp, pages["k"][i], pages["v"][i],
                                 block_tables, ctx_lens, valid, use_kernel)
    return _unembed(params, cfg, x[:, n_soft:]), pages


def decode_step_paged(params: Params, cfg: ArchConfig, pages: Pages,
                      batch: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, ctx_lens: torch.Tensor, *,
                      use_kernel: bool = False
                      ) -> Tuple[torch.Tensor, Pages]:
    """One-token paged decode: batch {"tokens": [B, 1]} -> (logits
    [B, 1, V], pages).  ``use_kernel`` routes attention through the CUDA
    block-indexed kernel."""
    return forward_paged(params, cfg, pages, batch, block_tables, ctx_lens,
                         use_kernel=use_kernel)


__all__ = ["PAGED_FAMILIES", "Pages", "supports_paged", "init_pages",
           "copy_blocks", "forward_paged", "decode_step_paged"]
