"""Expert-parallel MoE dispatch through the CollectiveEngine's AllToAll
(counterpart of ``repro/models/moe_ep.py``).

``moe.moe_ffn_sharded`` keeps the tokens replicated over the expert axis
and communicates only in the combine (one psum).  Here the tokens are
sharded over the EP axes: each rank routes only its own tokens, and
dispatch and combine are explicit **all-to-all** exchanges routed
through ``CollectiveEngine.all_to_all_multi``, so the planner prices the
exchange per axis (hierarchical, sequential, flat, pipelined) and the
decision lands in the persistent cache.

Layout, on each rank of the ambient grid (``models.layers.ambient_grid``):

* tokens ``x [G_l, gs, D]``: this rank's rows over the grid's DP axes,
  as every model call under a grid receives them; when the EP axis is
  ``"model"`` (the rows are replicated over it) each model rank takes
  its block of them, and the result is all-gathered back over "model";
* experts ``w_* [E, ...]`` arrive whole (a whole tree): rank r of the
  folded EP axes cuts experts ``[r E_l, (r + 1) E_l)`` with
  ``sharding.rules.local_shard``; or as a rank's tree holds them (its
  ``E / m`` over "model", ``sharding.rules.shard_params``); a tree's
  leaves cut over "data" (ZeRO-3) are gathered just in time first;
* dispatch: ``moe_ffn``'s group-local sort builds the ``[G_l, E, Cap,
  D]`` buffer, reordered destination-rank-major and exchanged (chunk r
  -> rank r); the reverse exchange brings the expert outputs home for
  the weighted combine.

Per-token results equal ``moe.moe_ffn``'s up to float32 reassociation:
routing, capacity and the keep / pos bookkeeping are the same; only
where each expert's FFN runs differs.  ``algorithm="lax"`` is the
communicator's native all-to-all over the folded EP axes (the reference's
bare ``lax.all_to_all``); any other name goes to the engine (``"auto"``,
a plan shape, or a 1D backend).  The exchange is its own transpose, so
the backward runs it again on the cotangents; gradients otherwise follow
``moe.py``'s rules.  On CUDA rank threads the backward is refused
(ROADMAP C15): EP training on cards runs one process a rank.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.layers import _ambient_grid
from repro_torch.models.moe import (Routing, _combine, _dispatch,
                                    _experts, expert_weights,
                                    moe_ffn_sharded, pmean, psum_grad,
                                    refuse_cuda_thread_backward, scale_grad)
from repro_torch.sharding.rules import for_grid

_warned_fallback = False


def _fallback(reason: str, x, router_w, w_gate, w_up, w_down, *,
              top_k: int, capacity_factor: float):
    """Route through the replicated-token path, loudly: a config that
    silently skips the EP exchange would make --moe-ep smokes vacuous."""
    global _warned_fallback
    if not _warned_fallback:
        _warned_fallback = True
        print(f"[moe_ep] WARNING: falling back to the replicated-token "
              f"shard_map path (no all-to-all dispatch): {reason}")
    return moe_ffn_sharded(x, router_w, w_gate, w_up, w_down,
                           top_k=top_k, capacity_factor=capacity_factor)


def _ep_axes_for(grid) -> Tuple[str, ...]:
    """Grid axes the expert dim shards over: the model axis when the
    grid has a non-trivial one, else the folded DP axes (the ("pod",
    "data") expert grid the planner's 2-phase decomposition targets).
    Size-1 axes are skipped so a trivial model axis does not shadow a
    usable expert grid."""
    sizes = dict(zip(grid.axis_names, grid.shape))
    if sizes.get("model", 0) > 1:
        return ("model",)
    return tuple(a for a in ("pod", "data") if sizes.get(a, 0) > 1)


class _Exchange(torch.autograd.Function):
    """The EP all-to-all (``lax.all_to_all(.., split_axis=0,
    concat_axis=0, tiled=True)`` over the folded EP axes); its transpose
    is itself."""

    @staticmethod
    def forward(ctx, v, fn):
        ctx.fn = fn
        return fn(v.contiguous())

    @staticmethod
    def backward(ctx, ct):
        return ctx.fn(ct.contiguous()), None


class _GatherRows(torch.autograd.Function):
    """Forward: every model rank's block of rows, gathered.  Backward:
    this rank's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, y, comm):
        ctx.comm, ctx.rows = comm, y.shape[0]
        return comm.all_gather(y.contiguous())

    @staticmethod
    def backward(ctx, ct):
        return ct.narrow(0, ctx.comm.rank * ctx.rows, ctx.rows), None


def _moe_ep_local(x, router_w, w_gate, w_up, w_down, *, top_k: int,
                  capacity_factor: float, grid, ep_axes: Tuple[str, ...],
                  token_axes: Tuple[str, ...], algorithm: str, engine):
    """One rank's body.  x: [G_l, gs, D] (its token groups); router_w:
    [D, E] whole; w_gate/w_up: [E_l, D, F]; w_down: [E_l, F, D]."""
    g, gs, d = x.shape
    e_total = router_w.shape[1]
    e_local = w_gate.shape[0]
    n_ranks = e_total // e_local

    # ---- router + group-local sort dispatch (identical to moe_ffn) ----
    r = Routing(x, router_w, top_k, capacity_factor)
    cap = r.cap
    aux = r.aux
    for ax in token_axes:
        aux = pmean(aux, grid.sub(ax))
    buf = _dispatch(x, r, r.sorted_e, r.pos, r.keep, e_total)

    # ---- dispatch all-to-all: chunk r carries rank r's experts ----
    if algorithm == "lax":
        comm = grid.sub(ep_axes)

        def fn(flat):
            return comm.all_to_all(flat)
    else:
        def fn(flat):
            return engine.all_to_all_multi(flat, grid, ep_axes,
                                           algorithm=algorithm)

    def exchange(v):
        flat = v.reshape(n_ranks * g * e_local * cap, d)
        return _Exchange.apply(flat, fn).reshape(n_ranks, g, e_local, cap, d)

    send = buf.reshape(g, n_ranks, e_local, cap, d).transpose(0, 1)
    recv = exchange(send)       # [src rank, its G_l, my E_l, cap, D]

    # ---- expert compute on every rank's tokens for my experts ----
    tok = recv.permute(2, 0, 1, 3, 4).reshape(e_local, n_ranks * g * cap, d)
    y = _experts(tok[None], w_gate, w_up, w_down)[0]

    # ---- combine all-to-all: results home to their token owners ----
    y = y.reshape(e_local, n_ranks, g, cap, d).permute(1, 2, 0, 3, 4)
    back = exchange(y)          # [expert rank, my G_l, its E_l, cap, D]
    y_buf = back.transpose(0, 1).reshape(g, e_total, cap, d)
    return _combine(y_buf, r, r.sorted_e, r.pos, r.keep, x), aux


def moe_ffn_ep(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               capacity_factor: float = 1.25, algorithm: str = "auto",
               engine=None):
    """Engine-routed expert-parallel MoE when the ambient grid has an EP
    axis; falls back, loudly, to ``moe_ffn_sharded`` (and transitively
    ``moe_ffn``) when there is no grid or the shapes do not tile the EP
    world.  ``x`` is this rank's rows over the grid's DP axes; the
    result is too."""
    grid = _ambient_grid()
    ep_axes = _ep_axes_for(grid) if grid is not None else ()
    if grid is None or not ep_axes:
        return _fallback("no ambient mesh / no EP-capable axis", x,
                         router_w, w_gate, w_up, w_down, top_k=top_k,
                         capacity_factor=capacity_factor)
    names = grid.axis_names
    sizes = dict(zip(names, grid.shape))
    dp_axes = tuple(a for a in ("pod", "data")
                    if a in names and a not in ep_axes)
    token_axes = dp_axes + ep_axes
    e_total = router_w.shape[1]
    n_ranks = math.prod(sizes[a] for a in ep_axes)
    n_tok = n_ranks * math.prod(sizes[a] for a in dp_axes)
    # the global batch: x holds this rank's block of it over the DP axes
    g_global = x.shape[0] * math.prod(sizes[a]
                                      for a in for_grid(grid).data_axes)
    if n_ranks == 1 or e_total % n_ranks != 0 or g_global % n_tok != 0:
        return _fallback(
            f"E={e_total} over {n_ranks} EP ranks ({ep_axes}) or "
            f"G={g_global} over {n_tok} token shards does not tile",
            x, router_w, w_gate, w_up, w_down, top_k=top_k,
            capacity_factor=capacity_factor)
    if engine is None and algorithm != "lax":
        from repro_torch.collectives.api import get_engine
        engine = get_engine(device=grid.device)
    refuse_cuda_thread_backward(x, grid, "moe_ffn_ep")

    model = grid.sub("model") if "model" in ep_axes else None
    if model is not None:
        # the rows are replicated over "model": each rank takes its block
        x = psum_grad(x, model)
        router_w = psum_grad(router_w, model)
        rows = x.shape[0] // model.size
        x = x.narrow(0, model.rank * rows, rows)
    ep_spec = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    wg, wu, wd = expert_weights(grid, w_gate, w_up, w_down, ep_spec,
                                e_total)
    out, aux = _moe_ep_local(x, router_w, wg, wu, wd, top_k=top_k,
                             capacity_factor=capacity_factor, grid=grid,
                             ep_axes=ep_axes, token_axes=token_axes,
                             algorithm=algorithm, engine=engine)
    if model is not None:
        out = _GatherRows.apply(out, model)
        aux = scale_grad(aux, 1.0 / model.size)
    return out, aux


__all__ = ["moe_ffn_ep"]
