"""Model parameters and entry points (counterpart of
``repro/models/transformer.py``) for the dense and MoE decoders, the
Mamba SSM stack, the RG-LRU hybrid and the encoder-decoder backbone:
parameters, embedding (with vision soft tokens prepended), unembedding
and the FFN sublayer (which the paged serving path runs too,
``models/paged.py``), the dense decoder block, the hybrid's two blocks,
the encoder and the cross-attending decoder layer, and the three entry
points of every family

    forward_train(params, cfg, batch)              -> (logits, aux)
    prefill(params, cfg, batch)                    -> (logits, cache)
    decode_step(params, cfg, cache, batch)         -> (logits, cache)

with ``init_cache`` for their decode caches.

Parameters are a plain dictionary, as the reference's pytree, except
that the layer stack is a Python list of per-layer dictionaries instead
of ``[L, ...]`` arrays stacked for ``lax.scan``::

    dense: {"embed": [V, D], "ln_f": [D], "head": [D, V],
            "layers": [{"ln1", "ln2", "wq", "wk", "wv", "wo",
                        "wg", "wu", "wd"}, ...]}
    moe:   the dense layer with "router" [D, E] (float32), "eg", "eu"
           [E, D, F], "ed" [E, F, D] in place of "wg", "wu", "wd", and
           "dense_mlp" {"wg", "wu", "wd"} when ``moe_dense_ff`` is set
           (Arctic's parallel dense residual)
    ssm:   {"embed", "ln_f", "head",
            "layers": [{"ln", "in_proj", "conv_w", "x_proj", "dt_w",
                        "dt_b", "a_log", "d_skip", "out_proj"}, ...]}
    hybrid: {"embed", "ln_f", "head",
             "cycles": {"b0": [block, ...], "b1": [...], ...},
             "tail": (block, ...)}
    encdec: {"embed", "ln_f", "head",
             "encoder": [{"ln1", "ln2", "wq", "wk", "wv", "wo",
                          "wg", "wu", "wd"}, ...], "enc_ln_f": [D],
             "layers": [{"ln1", "lnx", "ln2", "wq", "wk", "wv", "wo",
                         "x_wq", "x_wk", "x_wv", "x_wo",
                         "wg", "wu", "wd"}, ...]}

The hybrid keeps the reference's layout: ``cycles["b{j}"]`` lists, cycle
by cycle, the block of kind ``block_pattern[j]`` (a "local" block is the
dense decoder layer, an "rglru" block {"ln", "w_x", "w_y", "conv_w",
"w_a", "w_i", "lam" (float32), "out"}); ``tail`` holds the
``num_layers % len(block_pattern)`` blocks after the last whole cycle,
of kinds ``block_pattern[:len(tail)]``.  ``tail`` is a tuple, not a
list: a list is a stack of layers in the port's tree rules
(``repro_torch.tree``), and the reference keeps its tail unstacked.  So
the optimizer's weight decay (by stacked rank) and the DP sync's flat
vectors see the reference's tree.

``use_kernel`` (``None``: when the parameters live on a CUDA device)
routes the long-sequence attention of the dense, MoE, hybrid and
encoder-decoder families through the flash kernel (the encoder's and the
cross-attention's on its non-causal route) and the SSM's scan through
the scan kernels.
The MoE FFN (``models/moe.py``, ``moe_ep.py``) and the RG-LRU
recurrence (``models/rglru.py``) are plain PyTorch, as the reference
has no kernel for them.  A decode cache's K and V are written in place:
``decode_step`` returns the K/V tensors it was given, updated.

A tree of one rank's shards (``sharding.rules.shard_params``) runs the
tensor-parallel block under an ambient grid with its "model" axis: each
entry point binds that axis (``layers.model_parallel``), attention runs
on the rank's heads, the FFN on its hidden block, the MoE on its
experts, the SSM on its channels, the RG-LRU on its blocks, each block's
two row-parallel outputs reduced over "model" through the engine.  The
embedding is vocab-parallel over the vocabulary padded to the model axis
(``sharding.rules.padded_vocab``); ``forward_train`` then returns this
rank's block [B, S, Vp / m] of the padded vocabulary's logits (a pad
column's logit is 0), which ``train.step.cross_entropy`` reduces over
"model" without the pad columns, while ``prefill`` and ``decode_step``
return whole logits over the V real ids.  Their caches hold the rank's
kv heads (``init_cache(..., tp=m)``, ``shard_decode_cache``), channels and
blocks.  Where the heads are padded to the model axis
(``sharding.rules.padded_heads``) a rank's pad heads attend like the
others and their output is multiplied by zero before ``wo``
(:func:`_mask_pad_heads`), so they change nothing, forward or backward.
A tree cut over "data" too gathers each layer's leaves just before the
layer runs (``layers.gather_layer``; in ``forward_train`` inside the
checkpointed function, so the recompute gathers again and no whole
layer is saved), and the embedding and head in :func:`_embed` /
:func:`_unembed`.

Vision configs (``frontend == "vision"``) take ``batch["soft_emb"]``
[B, n_soft, D] in ``forward_train`` and ``prefill``: the soft tokens
come first, and ``forward_train`` returns logits over the token
positions only.  The encoder-decoder family takes ``batch["frames"]``
[B, S_enc, D] (``models/frontend.py``'s stub embeddings) in
``forward_train`` and ``prefill``; its decode cache adds the cross K/V
of every decoder layer over the encoder's output.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_or_meta
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (_ambient_grid, _data_cut,
                                      _direct_attention, _repeat_kv, _tp,
                                      ambient_grid, apply_rope, attention,
                                      bind_data, bind_tp, copy_to_model,
                                      flash_decode, fused_tp_enabled,
                                      gather_from_model, gather_layer,
                                      gather_leaf, model_parallel,
                                      reduce_from_model,
                                      refuse_cuda_thread_backward, rms_norm,
                                      swiglu, use_flash_decode)
from repro_torch.sharding.rules import (_kv_replicated, padded_heads,
                                        real_heads)

Params = Dict[str, Any]


def _norm(d: int, dtype, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=dtype, device=device)


def _dense(gen: Optional[torch.Generator], shape, scale: float, dtype
           ) -> torch.Tensor:
    if gen is None:                     # the meta device: shapes only
        return torch.empty(shape, dtype=dtype, device="meta")
    # float32 normals scaled, then cast: the reference's recipe
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def _mlp_layer(gen: Optional[torch.Generator], d: int, f: int, dtype
               ) -> Params:
    return {"wg": _dense(gen, (d, f), d ** -0.5, dtype),
            "wu": _dense(gen, (d, f), d ** -0.5, dtype),
            "wd": _dense(gen, (f, d), f ** -0.5, dtype)}


def _moe_layer(gen: Optional[torch.Generator], cfg: ArchConfig, dtype
               ) -> Params:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    p = {"router": _dense(gen, (d, e), d ** -0.5, torch.float32),
         "eg": _dense(gen, (e, d, f), d ** -0.5, dtype),
         "eu": _dense(gen, (e, d, f), d ** -0.5, dtype),
         "ed": _dense(gen, (e, f, d), f ** -0.5, dtype)}
    if cfg.moe_dense_ff:
        p["dense_mlp"] = _mlp_layer(gen, d, cfg.moe_dense_ff, dtype)
    return p


def _attn_layer(gen: Optional[torch.Generator], cfg: ArchConfig, dtype
                ) -> Params:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = d ** -0.5
    return {"wq": _dense(gen, (d, h * hd), s, dtype),
            "wk": _dense(gen, (d, kv * hd), s, dtype),
            "wv": _dense(gen, (d, kv * hd), s, dtype),
            "wo": _dense(gen, (h * hd, d), (h * hd) ** -0.5, dtype)}


def _decoder_layer(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
                   device: torch.device) -> Params:
    d = cfg.d_model
    p = {"ln1": _norm(d, dtype, device), "ln2": _norm(d, dtype, device),
         **_attn_layer(gen, cfg, dtype)}
    if cfg.family == "moe":
        p.update(_moe_layer(gen, cfg, dtype))
    else:
        p.update(_mlp_layer(gen, d, cfg.d_ff, dtype))
    return p


def _encdec_layers(gen: Optional[torch.Generator], cfg: ArchConfig, dtype,
                   device: torch.device) -> Params:
    """The encoder stack, its final norm and the decoder stack (self-
    attention, cross-attention ``x_*``, SwiGLU), at the reference's
    scales."""
    d = cfg.d_model

    def norms(*names):
        return {name: _norm(d, dtype, device) for name in names}

    encoder = [{**norms("ln1", "ln2"), **_attn_layer(gen, cfg, dtype),
                **_mlp_layer(gen, d, cfg.d_ff, dtype)}
               for _ in range(cfg.encoder_layers)]
    layers = [{**norms("ln1", "lnx", "ln2"), **_attn_layer(gen, cfg, dtype),
               **{f"x_{k}": w for k, w in _attn_layer(gen, cfg,
                                                      dtype).items()},
               **_mlp_layer(gen, d, cfg.d_ff, dtype)}
              for _ in range(cfg.num_layers)]
    return {"encoder": encoder, "enc_ln_f": _norm(d, dtype, device),
            "layers": layers}


#: the families whose parameters the port initialises: every family of
#: the configs
INIT_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")


def kernel_route(params: Params, use_kernel: Optional[bool]) -> bool:
    """``use_kernel``, or, when it is None, whether the parameters live
    on a CUDA device: the kernels run on the card, their plain versions
    on the CPU.  A meta tree takes the card's route (the kernels'
    shape-only bodies, ``ops.on_card_route``)."""
    if use_kernel is not None:
        return use_kernel
    return ops.on_card_route(params["embed"])


def init_params(cfg: ArchConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random weights of a dense or MoE decoder, a Mamba stack, an
    RG-LRU hybrid or an encoder-decoder, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (default ``cuda``).  Shapes and
    scales follow the reference; norm weights start at zero.  The draws
    differ from ``jax.random``'s: to hold the port against the reference
    on the same weights, convert them with
    ``repro_torch.convert.params_from_jax``.  ``device="meta"`` gives
    every shape and dtype with nothing allocated (:func:`param_specs`)."""
    if cfg.family not in INIT_FAMILIES:
        raise ValueError(f"init_params: unknown family {cfg.family!r}")
    gen = None
    dev = resolve_or_meta(device)
    if dev.type != "meta":
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
                                         cfg.dt_rank, cfg.ssm_conv, dtype,
                                         dev)}
            for _ in range(cfg.num_layers)]
        return params
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern
        n_cycles, rem = divmod(cfg.num_layers, len(pattern))

        def block(kind):
            if kind == "local":
                return _decoder_layer(gen, cfg, dtype, dev)
            return {"ln": _norm(d, dtype, dev),
                    **rglru_lib.init_rglru_params(gen, d, d, cfg.num_heads,
                                                  cfg.ssm_conv, dtype, dev)}

        # drawn in layer order, as the reference draws its keys
        cycles = [[block(kind) for kind in pattern] for _ in range(n_cycles)]
        params["cycles"] = {f"b{j}": [cyc[j] for cyc in cycles]
                            for j in range(len(pattern))}
        params["tail"] = tuple(block(pattern[j]) for j in range(rem))
        return params
    if cfg.family == "encdec":
        params.update(_encdec_layers(gen, cfg, dtype, dev))
        return params
    params["layers"] = [_decoder_layer(gen, cfg, dtype, dev)
                        for _ in range(cfg.num_layers)]
    return params


def param_specs(cfg: ArchConfig) -> Params:
    """Shapes and dtypes of every parameter with nothing allocated (meta
    tensors): the reference's ``param_specs``."""
    return init_params(cfg, device="meta")


def _lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``; on a rank's tree the
    vocab-parallel lookup: its rows, zeros elsewhere, reduced over
    "model" (ids are below V, so no pad row is read)."""
    comm = _tp()
    if comm is None:
        return emb[tokens]
    n = emb.shape[0]
    local = tokens.long() - comm.rank * n
    mine = (local >= 0) & (local < n)
    rows = emb[local.clamp(0, n - 1)]
    return reduce_from_model(torch.where(mine[..., None], rows,
                                         torch.zeros_like(rows)))


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
           soft_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled token embeddings, after the vision soft tokens [B, n_soft,
    D] when given (cast to the embeddings' dtype)."""
    x = _lookup(gather_leaf(params["embed"]), tokens)
    # the sqrt(d_model) scale is rounded to the activation dtype first
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    x = x * scale
    if soft_emb is not None:
        x = torch.cat([soft_emb.to(x.dtype), x], dim=1)
    return x


def _unembed(params: Params, cfg: ArchConfig,
             x: torch.Tensor) -> torch.Tensor:
    """Logits in the output dtype; on a rank's tree its block of the
    padded vocabulary's."""
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    head = gather_leaf(params["head"])
    # head matmul in the activation dtype, then the cast (inputs are not
    # upcast first)
    out_dtype = torch.bfloat16 if cfg.logits_bf16 else torch.float32
    return (copy_to_model(x) @ head).to(out_dtype)


def _whole_logits(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """On a rank's tree, the ranks' blocks of the padded vocabulary's
    logits gathered over "model", the pad columns dropped: [..., V]."""
    if _tp() is None:
        return logits
    return gather_from_model(logits).narrow(-1, 0, cfg.vocab_size)


def _ffn_sublayer(cfg: ArchConfig, x: torch.Tensor, p: Params
                  ) -> Tuple[torch.Tensor, Any]:
    """Returns (ffn_out, aux_loss): the dense SwiGLU, or the MoE FFN
    chosen as the reference chooses it (``moe_ep``: the engine's
    all-to-all; ``moe_shardmap_ep``: the model-axis path; else the
    one-device one), plus Arctic's dense residual."""
    if cfg.family == "moe":
        if _tp() is not None and not cfg.moe_ep:
            # a rank's experts: the model-axis path, never the one-device
            moe_fn = moe_lib.moe_ffn_sharded
        elif cfg.moe_ep:
            from repro_torch.models.moe_ep import moe_ffn_ep

            def moe_fn(*a, **kw):
                return moe_ffn_ep(*a, algorithm=cfg.moe_ep_algorithm, **kw)
        else:
            moe_fn = (moe_lib.moe_ffn_sharded if cfg.moe_shardmap_ep
                      else moe_lib.moe_ffn)
        out, aux = moe_fn(x, p["router"], p["eg"], p["eu"], p["ed"],
                          top_k=cfg.experts_per_token,
                          capacity_factor=cfg.capacity_factor)
        if cfg.moe_dense_ff:
            dm = p["dense_mlp"]
            out = out + swiglu(x, dm["wg"], dm["wu"], dm["wd"])
        return out, aux
    return swiglu(x, p["wg"], p["wu"], p["wd"]), 0.0


# ====================================================================== #
# the dense decoder: block, train / prefill / decode
# ====================================================================== #
KV = Tuple[torch.Tensor, torch.Tensor]


def local_kv_heads(cfg: ArchConfig, tp: int = 1) -> int:
    """The kv heads a rank of a model axis of ``tp`` attends with (and
    caches): its block of the (padded) kv heads, or the one its q heads
    use where they are fewer than the ranks."""
    return 1 if _kv_replicated(cfg, tp) else padded_heads(cfg, tp)[1] // tp


def _mask_pad_heads(cfg: ArchConfig, out: torch.Tensor) -> torch.Tensor:
    """``out`` [B, S, H_l, hd] with this rank's pad heads (the last ones
    of its block, ``sharding.rules.head_block``) multiplied by zero: a
    pad q head of a GQA group attends over the group's real keys, and its
    output would reach ``wo``'s zero rows' gradient."""
    comm = _tp()
    if comm is None:
        return out
    n_real = real_heads(cfg, comm.size, comm.rank)
    h = out.shape[2]
    if n_real == h:
        return out
    mask = torch.cat([out.new_ones(n_real), out.new_zeros(h - n_real)])
    return out * mask[:, None]


def _q_proj(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor
            ) -> torch.Tensor:
    """[B, S, H_l, hd]: the q heads ``w``'s columns hold."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    return (x @ w).reshape(b, s, w.shape[1] // hd, hd)


def _kv_proj(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """[B, S, kv_l, hd]: the kv heads this rank attends with.  On a
    rank's tree with fewer kv heads than ranks ``w`` is whole (its
    gradient a partial sum on each rank, so it passes ``copy_to_model``)
    and the rank keeps the head its q heads use."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    comm = _tp()
    if comm is None or not _kv_replicated(cfg, comm.size):
        return (x @ w).reshape(b, s, w.shape[1] // hd, hd)
    y = (x @ copy_to_model(w)).reshape(b, s, cfg.num_kv_heads, hd)
    # the group of the rank's q heads: m / kv ranks a group (padded or not)
    j = comm.rank * cfg.num_kv_heads // comm.size
    return y[:, :, j:j + 1]


def _attention_sublayer(cfg: ArchConfig, x: torch.Tensor, p: Params, *,
                        causal: bool = True, window: Optional[int] = None,
                        pos: int = 0, cache_kv: Optional[KV] = None,
                        smax: Optional[int] = None,
                        use_kernel: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, KV]:
    """Returns (attn_out, new (k, v)).  Without a cache: self-attention
    over x, returning its rotated K and V.  With ``cache_kv`` (k, v)
    [B, Smax, Hkv, hd]: x's K and V are written into the cache **in
    place** at ``min(pos, Smax - S)`` (the reference's
    ``dynamic_update_slice`` start: with no headroom a decode step
    overwrites the last cached position), and x attends over the cache up
    to ``pos + S``.

    ``smax`` is the cache's global length when ``cache_kv`` holds only
    this rank's sequence block (``shard_decode_cache``): a decode step
    then writes K and V only where ``write`` falls in the block and runs
    ``flash_decode`` across the ambient grid's model axis, where the
    reference's ``use_flash_decode`` applies."""
    b, s, _ = x.shape
    x = copy_to_model(x)
    q = _q_proj(cfg, x, p["wq"])
    k = _kv_proj(cfg, x, p["wk"])
    v = _kv_proj(cfg, x, p["wv"])
    h, hd = q.shape[2], q.shape[3]
    positions = pos + torch.arange(s, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache_kv is None:
        out = attention(q, k, v, causal=causal, window=window,
                        probs_bf16=cfg.attn_probs_bf16,
                        use_kernel=use_kernel)
        new_kv = (k, v)
    else:
        ck, cv = cache_kv
        s_local = ck.shape[1]
        smax = s_local if smax is None else smax
        write = min(pos, smax - s)
        if _tp() is None and ck.shape[2] != cfg.num_kv_heads:
            raise ValueError("a head-sharded KV cache needs a tree of "
                             "shards (sharding.rules.shard_params)")
        grid = (use_flash_decode(b, s, smax, cfg.num_kv_heads)
                if causal and not window and _tp() is None else None)
        if grid is not None:
            offset = grid.axis_index("model") * s_local
            if smax != s_local * grid.axis_size("model"):
                raise ValueError(f"cache block of {s_local} positions for a "
                                 f"cache of {smax} over the model axis")
            if offset <= write < offset + s_local:
                ck[:, write - offset] = k[:, 0].to(ck.dtype)
                cv[:, write - offset] = v[:, 0].to(cv.dtype)
            out = flash_decode(q, ck, cv, pos + s, grid)
        elif s_local != smax:
            raise ValueError("a sequence-sharded cache needs the "
                             "sequence-parallel decode (use_flash_decode) "
                             "over a whole tree")
        else:
            ck[:, write:write + s] = k.to(ck.dtype)
            cv[:, write:write + s] = v.to(cv.dtype)
            out = attention(q, ck, cv, causal=causal, window=window,
                            q_offset=pos, kv_len=pos + s,
                            probs_bf16=cfg.attn_probs_bf16,
                            use_kernel=use_kernel)
        new_kv = (ck, cv)
    out = _mask_pad_heads(cfg, out)
    return reduce_from_model(out.reshape(b, s, h * hd) @ p["wo"]), new_kv


def _decoder_block(cfg: ArchConfig, x: torch.Tensor, p: Params, *,
                   pos: int = 0, cache_kv: Optional[KV] = None,
                   smax: Optional[int] = None,
                   window: Optional[int] = None,
                   use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, KV, Any]:
    """Pre-norm attention + dense or MoE FFN; returns (out, new_kv,
    aux).  The reference's ``grad_barrier`` and ``sp_residuals`` are
    sharding levers (an optimization barrier on the TP all-reduce, a
    sequence-sharded residual): on one device they change nothing, and
    are ignored."""
    a, new_kv = _attention_sublayer(
        cfg, rms_norm(x, p["ln1"], cfg.norm_eps), p, causal=True,
        window=window, pos=pos, cache_kv=cache_kv, smax=smax,
        use_kernel=use_kernel)
    x = x + a
    f, aux = _ffn_sublayer(cfg, rms_norm(x, p["ln2"], cfg.norm_eps), p)
    return x + f, new_kv, aux


def _remat(fn, grid, *args):
    """``fn(*args)`` checkpointed (non-reentrant ``torch.utils.checkpoint``,
    the reference's ``jax.checkpoint`` with ``nothing_saveable``).  The
    recompute runs where the autograd engine runs it: on CUDA its own
    device thread, where this thread's ambient grid is not bound (ROADMAP
    C24); it binds the forward's (its model axis and data cut too)."""
    tp, data = _tp(), _data_cut()

    def bound(*a):
        with ambient_grid(grid), bind_tp(tp), bind_data(data):
            return fn(*a)
    return checkpoint(bound, *args, use_reentrant=False)


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


# ====================================================================== #
# the RG-LRU hybrid: blocks, prefill and decode over a ring of the window
# ====================================================================== #
def _hybrid_cycles(params: Params, cfg: ArchConfig
                   ) -> Tuple[list, list]:
    """(cycles, tail): each whole cycle as [(kind, block params), ...] in
    pattern order, and the tail's blocks as single (kind, params) pairs."""
    pattern = cfg.block_pattern
    cyc = params["cycles"]
    n_cycles = len(cyc["b0"]) if cyc else 0
    cycles = [[(kind, cyc[f"b{j}"][c]) for j, kind in enumerate(pattern)]
              for c in range(n_cycles)]
    return cycles, [(pattern[j], tp) for j, tp in enumerate(params["tail"])]


def _hybrid_layers(params: Params, cfg: ArchConfig) -> list:
    """Every (kind, block params) pair in layer order."""
    cycles, tail = _hybrid_cycles(params, cfg)
    return [pair for cyc in cycles for pair in cyc] + tail


def _hybrid_block(cfg: ArchConfig, kind: str, x: torch.Tensor, p: Params,
                  *, cache: Optional[rglru_lib.RGLRUState] = None,
                  single_step: bool = False,
                  use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor,
                                                              Any]:
    """kind "local": the dense decoder block with the sliding window
    (returns its (k, v)); kind "rglru": the RG-LRU block after an RMSNorm,
    residual added, no FFN (returns its state)."""
    if kind == "local":
        y, new_kv, _ = _decoder_block(cfg, x, p, window=cfg.local_window,
                                      use_kernel=use_kernel)
        return y, new_kv
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    y, state = rglru_lib.rglru_block(h, p, state=cache,
                                     single_step=single_step)
    return x + y, state


def _ring(kv: torch.Tensor, w: int) -> torch.Tensor:
    """A prompt's keys (or values) [B, S, Hkv, hd] as the decode ring
    [B, w, Hkv, hd]: position p of the trailing window at slot p % w,
    zeros in the slots no position reached.  Decode writes position
    ``pos`` at slot ``pos % w`` and keeps slots [0, min(pos + 1, w)), so
    it attends over the window ``forward_train`` does.  (The reference
    stores the trailing window from slot 0, or a short prompt
    left-padded: the two agree only when S is a multiple of w, ROADMAP
    C25.)"""
    b, s = kv.shape[:2]
    ring = kv.new_zeros((b, w) + tuple(kv.shape[2:]))
    lo = max(s - w, 0)
    slots = torch.arange(lo, s, device=kv.device) % w
    ring[:, slots] = kv[:, lo:]
    return ring


def _hybrid_prefill(params: Params, cfg: ArchConfig, x: torch.Tensor,
                    use_kernel: bool
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s = x.shape[:2]
    w = cfg.local_window
    ks, vs, convs, hs = [], [], [], []
    for kind, p in _hybrid_layers(params, cfg):
        p = gather_layer(p)
        x, st = _hybrid_block(cfg, kind, x, p, use_kernel=use_kernel)
        if kind == "local":
            ks.append(_ring(st[0], w))
            vs.append(_ring(st[1], w))
        else:
            convs.append(st.conv)
            hs.append(st.h)
    tp = _tp()
    empty = x.new_zeros((0, b, w, local_kv_heads(cfg, tp.size if tp else 1),
                         cfg.resolved_head_dim))
    cache = {"k": torch.stack(ks) if ks else empty,
             "v": torch.stack(vs) if vs else empty.clone(),
             "conv": torch.stack(convs), "h": torch.stack(hs),
             "pos": torch.tensor(s, dtype=torch.int32)}
    return _unembed(params, cfg, x[:, -1:]), cache


def _local_decode(cfg: ArchConfig, x: torch.Tensor, p: Params, pos: int,
                  ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One token through a local block over its ring ck / cv [B, w, Hkv,
    hd]: K and V rotated at the absolute position and written in place at
    slot ``pos % w``, then direct attention over the min(pos + 1, w) slots
    written so far (every one within the window)."""
    b = x.shape[0]
    w = ck.shape[1]
    hn = copy_to_model(rms_norm(x, p["ln1"], cfg.norm_eps))
    positions = pos + torch.arange(1, device=x.device)
    q = apply_rope(_q_proj(cfg, hn, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_kv_proj(cfg, hn, p["wk"]), positions, cfg.rope_theta)
    v = _kv_proj(cfg, hn, p["wv"])
    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    ck[:, pos % w] = k[:, 0].to(ck.dtype)
    cv[:, pos % w] = v[:, 0].to(cv.dtype)
    group = h // kvh
    out = _direct_attention(q.transpose(1, 2),
                            _repeat_kv(ck.transpose(1, 2), group),
                            _repeat_kv(cv.transpose(1, 2), group),
                            causal=False, window=None,
                            kv_len=min(pos + 1, w))
    out = _mask_pad_heads(cfg, out.transpose(1, 2))
    x = x + reduce_from_model(out.reshape(b, 1, h * hd) @ p["wo"])
    f, _ = _ffn_sublayer(cfg, rms_norm(x, p["ln2"], cfg.norm_eps), p)
    return x + f


def _hybrid_decode(params: Params, cfg: ArchConfig,
                   cache: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pos = int(cache["pos"])
    ai = 0
    convs, hs = [], []
    for kind, p in _hybrid_layers(params, cfg):
        p = gather_layer(p)
        if kind == "local":
            x = _local_decode(cfg, x, p, pos, cache["k"][ai], cache["v"][ai])
            ai += 1
            continue
        ri = len(hs)
        st = rglru_lib.RGLRUState(conv=cache["conv"][ri], h=cache["h"][ri])
        x, st = _hybrid_block(cfg, kind, x, p, cache=st, single_step=True)
        convs.append(st.conv)
        hs.append(st.h)
    new_cache = dict(cache, conv=torch.stack(convs), h=torch.stack(hs),
                     pos=cache["pos"] + 1)
    return _unembed(params, cfg, x), new_cache


# ====================================================================== #
# the encoder-decoder (Whisper backbone)
# ====================================================================== #
def _encoder_forward(params: Params, cfg: ArchConfig, frames: torch.Tensor,
                     use_kernel: bool, grid=None) -> torch.Tensor:
    """frames [B, S_enc, D] (the stub frontend's embeddings) through the
    encoder: pre-norm non-causal self-attention with RoPE and SwiGLU, each
    layer checkpointed under autograd whatever ``remat`` says (as the
    reference), then the final norm."""
    def layer(h, lp):
        lp = gather_layer(lp)
        a, _ = _attention_sublayer(cfg, rms_norm(h, lp["ln1"], cfg.norm_eps),
                                   lp, causal=False, use_kernel=use_kernel)
        h = h + a
        return h + swiglu(rms_norm(h, lp["ln2"], cfg.norm_eps),
                          lp["wg"], lp["wu"], lp["wd"])

    x = frames
    for lp in params["encoder"]:
        x = (_remat(layer, grid, x, lp) if torch.is_grad_enabled()
             else layer(x, lp))
    return rms_norm(x, params["enc_ln_f"], cfg.norm_eps)


def _cross_kv(cfg: ArchConfig, enc_out: torch.Tensor, lp: Params) -> KV:
    """A decoder layer's cross K and V [B, S_enc, Hkv, hd] over the
    encoder's output (no RoPE)."""
    enc_out = copy_to_model(enc_out)
    return (_kv_proj(cfg, enc_out, lp["x_wk"]),
            _kv_proj(cfg, enc_out, lp["x_wv"]))


def _cross_attention(cfg: ArchConfig, x: torch.Tensor, p: Params,
                     enc_k: torch.Tensor, enc_v: torch.Tensor,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x's queries (no RoPE) over the encoder's K and V, non-causal: the
    flash kernel's non-causal route when S == S_enc > 2048 on the
    kernel route, else the direct path."""
    b, s, _ = x.shape
    q = _q_proj(cfg, copy_to_model(x), p["x_wq"])
    out = attention(q, enc_k, enc_v, causal=False, use_kernel=use_kernel)
    out = _mask_pad_heads(cfg, out)
    return reduce_from_model(out.reshape(b, s, -1) @ p["x_wo"])


def _dec_layer(cfg: ArchConfig, h: torch.Tensor, lp: Params, enc_kv: KV, *,
               pos: int = 0, cache_kv: Optional[KV] = None,
               use_kernel: Optional[bool] = None) -> Tuple[torch.Tensor, KV]:
    """Causal self-attention (over ``cache_kv`` in place when given),
    cross-attention over ``enc_kv``, SwiGLU; each pre-norm.  Returns (out,
    new self (k, v))."""
    a, new_kv = _attention_sublayer(
        cfg, rms_norm(h, lp["ln1"], cfg.norm_eps), lp, causal=True, pos=pos,
        cache_kv=cache_kv, use_kernel=use_kernel)
    h = h + a
    h = h + _cross_attention(cfg, rms_norm(h, lp["lnx"], cfg.norm_eps), lp,
                             *enc_kv, use_kernel=use_kernel)
    return h + swiglu(rms_norm(h, lp["ln2"], cfg.norm_eps),
                      lp["wg"], lp["wu"], lp["wd"]), new_kv


def _encdec_prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
                    use_kernel: bool
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The encoder over the frames, the cross K/V of every decoder layer,
    and the decoder over the prompt: last-position logits and the cache
    {"k", "v": [L, B, S, Hkv, hd], "enc_k", "enc_v": [L, B, S_enc, Hkv,
    hd], "pos": S}."""
    enc_out = _encoder_forward(params, cfg, batch["frames"], use_kernel)
    x = _embed(params, cfg, batch["tokens"])
    kvs, enc_kvs = [], []
    for lp in params["layers"]:
        lp = gather_layer(lp)
        enc_kv = _cross_kv(cfg, enc_out, lp)
        x, kv = _dec_layer(cfg, x, lp, enc_kv, use_kernel=use_kernel)
        kvs.append(kv)
        enc_kvs.append(enc_kv)
    cache = {"k": torch.stack([k for k, _ in kvs]),
             "v": torch.stack([v for _, v in kvs]),
             "enc_k": torch.stack([k for k, _ in enc_kvs]),
             "enc_v": torch.stack([v for _, v in enc_kvs]),
             "pos": torch.tensor(x.shape[1], dtype=torch.int32)}
    return _unembed(params, cfg, x[:, -1:]), cache


def _encdec_decode(params: Params, cfg: ArchConfig,
                   cache: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    pos = int(cache["pos"])
    for i, lp in enumerate(params["layers"]):
        lp = gather_layer(lp)
        x, _ = _dec_layer(cfg, x, lp, (cache["enc_k"][i], cache["enc_v"][i]),
                          pos=pos, cache_kv=(cache["k"][i], cache["v"][i]))
    return _unembed(params, cfg, x), dict(cache, pos=cache["pos"] + 1)


def forward_train(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
                  remat: bool = True, use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, Any]:
    """Returns (logits [B, S, V] over the token positions, aux_loss: the
    MoE layers' load-balance losses summed, 0.0 for the other families);
    on a rank's tree its block [B, S, Vp / m] of the padded vocabulary's
    logits (the module docstring).  See :func:`_forward_train` for the
    rest."""
    with model_parallel(params, cfg):
        return _forward_train(params, cfg, batch, remat, use_kernel)


def _forward_train(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
                   remat: bool = True, use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """``remat`` checkpoints each layer (``torch.utils.checkpoint``,
    non-reentrant: the counterpart of ``jax.checkpoint`` with
    ``nothing_saveable``), the hybrid each whole pattern cycle and not its
    tail, as the reference (the encoder's layers are checkpointed
    whatever ``remat`` says); ``use_kernel`` (None: on a CUDA device)
    routes the chunked attention (dense, MoE, the hybrid's local blocks,
    the encoder-decoder's three attentions) through the flash kernel and
    the SSM's scan through the fused scan kernels.  ``batch`` holds
    "tokens" [B, S], with "soft_emb" [B, n_soft, D] for a vision config
    and "frames" [B, S_enc, D] for the encoder-decoder."""
    uk = kernel_route(params, use_kernel)
    soft = batch.get("soft_emb")
    x = _embed(params, cfg, batch["tokens"], soft)
    grid = _ambient_grid()
    data = _data_cut()
    if remat and torch.is_grad_enabled() and x.requires_grad:
        # the layers' copy_to_model (and gather_layer) would refuse a
        # backward it cannot run (C15) inside torch's checkpoint, leaving
        # its generator suspended with saved-tensor hooks pushed on this
        # thread (ROADMAP C34): refuse before the first checkpoint
        if _tp() is not None:
            refuse_cuda_thread_backward(x, _tp(), "the tensor-parallel block")
        if data is not None:
            refuse_cuda_thread_backward(x, data[0], "the tree cut over data")
    if (remat and torch.is_grad_enabled() and fused_tp_enabled()
            and x.device.type == "cuda" and grid is not None
            and "model" in grid.axis_names
            and grid.axis_size("model") > 1):
        # the recompute of a checkpointed layer runs in the backward, on
        # the autograd engine's one worker thread per device, shared by
        # every rank thread: the ring's collectives would deadlock there
        raise NotImplementedError(
            "forward_train: remat with the fused TP down-projection on "
            "CUDA would run the ring inside the backward pass; pass "
            "remat=False")

    if cfg.family == "hybrid":
        def layer(h, blocks):
            for kind, p in blocks:
                h = _hybrid_block(cfg, kind, h, gather_layer(p),
                                  use_kernel=uk)[0]
            return h, 0.0
        cycles, tail = _hybrid_cycles(params, cfg)
        units = [(cyc, True) for cyc in cycles] + [([t], False)
                                                   for t in tail]
    elif cfg.family == "ssm":
        def layer(h, lp):
            return _ssm_layer(cfg, h, gather_layer(lp), uk)[0], 0.0
    elif cfg.family == "encdec":
        enc_out = _encoder_forward(params, cfg, batch["frames"], uk, grid)

        def layer(h, lp):
            lp = gather_layer(lp)
            return _dec_layer(cfg, h, lp, _cross_kv(cfg, enc_out, lp),
                              use_kernel=uk)[0], 0.0
    else:
        def layer(h, lp):
            h, _, aux = _decoder_block(cfg, h, gather_layer(lp),
                                       use_kernel=uk)
            return h, aux
    if cfg.family != "hybrid":
        units = [(lp, True) for lp in params["layers"]]

    aux = 0.0
    for lp, ckpt in units:
        if remat and ckpt and torch.is_grad_enabled():
            x, aux_i = _remat(layer, grid, x, lp)
        else:
            x, aux_i = layer(x, lp)
        aux = aux + aux_i
    if soft is not None:
        x = x[:, soft.shape[1]:]
    return _unembed(params, cfg, x), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               enc_len: int = 0, device: DeviceLike = None, tp: int = 1
               ) -> Dict[str, torch.Tensor]:
    """Zeroed decode cache on ``device`` (default ``cuda``).  Dense and MoE:
    per-layer K/V {"k", "v": [L, B, max_len, Hkv, hd]}; SSM: {"conv":
    [L, B, K-1, di], "h": [L, B, di, N] float32}; hybrid: the local
    blocks' rings {"k", "v": [n_local, B, w, Hkv, hd]} with w =
    min(local_window, max_len), the RG-LRU blocks' {"conv": [n_rglru, B,
    K-1, D], "h": [n_rglru, B, D] float32}; encoder-decoder: the dense
    K/V and the cross K/V {"enc_k", "enc_v": [L, B, enc_len, Hkv, hd]};
    each with "pos", an int32 scalar on the CPU.  ``tp``: one rank's
    cache of a model axis of that size (its kv heads, SSM channels and
    RG-LRU width).  ``device="meta"`` gives the shapes only (the
    dry-run's cache, ``launch.specs.decode_cache_specs``)."""
    dev = resolve_or_meta(device)
    dtype, n = cfg.activation_dtype, cfg.num_layers
    kvh = local_kv_heads(cfg, tp)
    pos = torch.zeros((), dtype=torch.int32)
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern
        n_attn = sum(pattern[i % len(pattern)] == "local" for i in range(n))
        w = min(cfg.local_window, max_len)
        kv = (n_attn, batch, w, kvh, cfg.resolved_head_dim)
        rec = (n - n_attn, batch)
        lru = cfg.d_model // tp
        return {"k": torch.zeros(kv, dtype=dtype, device=dev),
                "v": torch.zeros(kv, dtype=dtype, device=dev),
                "conv": torch.zeros(rec + (cfg.ssm_conv - 1, lru),
                                    dtype=dtype, device=dev),
                "h": torch.zeros(rec + (lru,), dtype=torch.float32,
                                 device=dev),
                "pos": pos}
    if cfg.family == "ssm":
        di = cfg.d_inner // tp
        return {"conv": torch.zeros((n, batch, cfg.ssm_conv - 1, di),
                                    dtype=dtype, device=dev),
                "h": torch.zeros((n, batch, di, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
                "pos": pos}
    shape = (n, batch, max_len, kvh, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": pos}
    if cfg.family == "encdec":
        enc = (n, batch, enc_len) + shape[3:]
        cache["enc_k"] = torch.zeros(enc, dtype=dtype, device=dev)
        cache["enc_v"] = torch.zeros(enc, dtype=dtype, device=dev)
    return cache


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
            use_kernel: Optional[bool] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward over a prompt, returning last-position logits [B, 1, V]
    and the decode cache: dense {"k", "v": [L, B, S, Hkv, hd]}, SSM
    {"conv": [L, B, K-1, di], "h": [L, B, di, N]}, hybrid
    :func:`init_cache`'s with w = local_window (the rings of
    :func:`_ring`), encoder-decoder the dense K/V with the cross K/V
    {"enc_k", "enc_v": [L, B, S_enc, Hkv, hd]} over ``batch["frames"]``;
    each with "pos" = S (an int32 scalar on the CPU).  With vision soft
    tokens (``batch["soft_emb"]``) the cache covers n_soft + S positions
    and "pos" is n_soft + S.  The dense (and the encoder-decoder's self)
    cache is exactly the prompt's length; to decode without overwriting
    its last position, pad it (the reference's own test pads by 8).
    Logits are whole on a rank's tree too."""
    with model_parallel(params, cfg):
        logits, cache = _prefill(params, cfg, batch, use_kernel)
        return _whole_logits(cfg, logits), cache


def _prefill(params: Params, cfg: ArchConfig, batch: Dict[str, Any],
             use_kernel: Optional[bool] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    uk = kernel_route(params, use_kernel)
    if cfg.family == "encdec":
        return _encdec_prefill(params, cfg, batch, uk)
    x = _embed(params, cfg, batch["tokens"], batch.get("soft_emb"))
    if cfg.family == "hybrid":
        return _hybrid_prefill(params, cfg, x, uk)
    s = x.shape[1]
    states = []
    for lp in params["layers"]:
        lp = gather_layer(lp)
        if cfg.family == "ssm":
            x, st = _ssm_layer(cfg, x, lp, uk)
            states.append((st.conv, st.h))
        else:
            x, kv, _ = _decoder_block(cfg, x, lp, use_kernel=uk)
            states.append(kv)
    names = ("conv", "h") if cfg.family == "ssm" else ("k", "v")
    cache = {name: torch.stack([st[i] for st in states])
             for i, name in enumerate(names)}
    cache["pos"] = torch.tensor(s, dtype=torch.int32)
    return _unembed(params, cfg, x[:, -1:]), cache


def decode_step(params: Params, cfg: ArchConfig,
                cache: Dict[str, torch.Tensor], batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  batch: {"tokens": [B, 1]}.  Returns (logits
    [B, 1, V], new cache).  The plain single-step arithmetic, as in the
    reference: the SSM's and the RG-LRU's recurrence step; the dense
    direct attention over the cache, and the hybrid's over its rings,
    whose K/V tensors are updated in place and returned in the new
    cache; the encoder-decoder's direct cross-attention over its
    ``enc_k`` / ``enc_v``.  Logits are whole on a rank's tree too."""
    with model_parallel(params, cfg):
        logits, cache = _decode_step(params, cfg, cache, batch)
        return _whole_logits(cfg, logits), cache


def _decode_step(params: Params, cfg: ArchConfig,
                 cache: Dict[str, torch.Tensor], batch: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x = _embed(params, cfg, batch["tokens"])
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, cache, x)
    if cfg.family == "encdec":
        return _encdec_decode(params, cfg, cache, x)
    if cfg.family == "ssm":
        convs, hs = [], []
        for i, lp in enumerate(params["layers"]):
            st = ssm_lib.SSMState(conv=cache["conv"][i], h=cache["h"][i])
            x, st = _ssm_layer(cfg, x, gather_layer(lp), False, state=st,
                               single_step=True)
            convs.append(st.conv)
            hs.append(st.h)
        new_cache = {"conv": torch.stack(convs), "h": torch.stack(hs),
                     "pos": cache["pos"] + 1}
        return _unembed(params, cfg, x), new_cache
    pos = int(cache["pos"])
    smax = int(cache.get("smax", cache["k"].shape[2]))
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _decoder_block(cfg, x, gather_layer(lp), pos=pos,
                                 cache_kv=(cache["k"][i], cache["v"][i]),
                                 smax=smax)
    return _unembed(params, cfg, x), dict(cache, pos=cache["pos"] + 1)


def shard_decode_cache(cfg: ArchConfig, cache: Dict[str, Any], grid
                       ) -> Dict[str, Any]:
    """This rank's blocks of a dense decode cache under the reference's
    cache specs over ``grid`` (``sharding.rules.cache_specs``): K and V
    sequence-sharded over "model" when the kv heads do not divide the
    axis and the length does, else whole.  A sequence-sharded cache
    carries its global length as ``"smax"``, which ``decode_step`` reads
    under the same ambient grid.  Views of ``cache``; decode writes into
    them in place.  K and V head-sharded when the kv heads divide the
    axis (the cache of a tree of shards, ``sharding.rules.shard_params``,
    which decodes on its heads); the SSM's conv window and state over
    their channels when those divide."""
    from repro_torch.sharding.rules import cache_specs, for_grid, local_shard

    specs = cache_specs(cfg, for_grid(grid), cache)
    out = {}
    for key, x in cache.items():
        spec = specs[key]
        out[key] = local_shard(x, spec, grid) if spec else x
    if specs["k"][2] is not None:
        out["smax"] = cache["k"].shape[2]
    return out


__all__ = ["INIT_FAMILIES", "Params", "decode_step", "forward_train",
           "init_cache", "init_params", "kernel_route", "local_kv_heads",
           "param_specs", "prefill", "shard_decode_cache"]
