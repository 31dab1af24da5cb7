"""Capacity-based top-k Mixture-of-Experts FFN (counterpart of
``repro/models/moe.py``).

Group-local sort-based dispatch: tokens are ``[G, gs, D]`` (G groups,
the batch rows); the router runs in float32, each token keeps its top-k
experts (renormalised), and a stable sort of the ``gs * k`` (token,
expert) entries of a group by expert id gives each entry its position
within its expert.  Entries at a position ``>= capacity`` are dropped
(the reference's ``mode="drop"`` scatter: here masked with ``keep`` and
sent to a sink row); the rest fill the ``[G, E, Cap, D]`` expert buffer,
which the experts' SwiGLU products (plain ``einsum``s, as in the
reference, where they run outside any kernel) turn into outputs.

The combine is deterministic: where the reference scatter-adds the
weighted outputs into their tokens in sorted order (for one token,
ascending expert id), the port gathers each token's k results, orders
them by expert id and adds them in that order, in the activation dtype.
No atomics, so two calls are bitwise equal on the card too.

The model axis (``moe_ffn_sharded``): where the reference reads the
ambient mesh, the port reads the thread's ambient grid
(``models.layers.ambient_grid``).  Under a grid with a ``"model"`` axis
the tokens stay replicated over it, each model rank computes its own
block of experts, and one psum over ``"model"`` combines them.  The
expert weights arrive as a rank's tree holds them (``sharding.rules.
shard_params``: its E / m experts, taken as they stand), or whole (a
whole tree under a model grid: each rank cuts its block with
``sharding.rules.local_shard``, their gradients reduced over "model"),
and on a tree cut over "data" too (ZeRO-3) the rank's real block of each
expert weight is all-gathered over "data" just in time
(``layers.gather_leaf``), as in the reference.

Gradients follow the reference's ``shard_map`` transpose with the port's
data-parallel step in mind (each rank differentiates its own loss; the
step averages gradients over the DP axes only): an input replicated
over ``"model"`` gets its cotangent psum'd over ``"model"`` in the
backward, a psum'd output passes its (replicated) cotangent through, and
an output replicated over ``"model"`` scales its cotangent by
``1 / model``.  Those psums run inside backward nodes: fine on the CPU
and in one process a rank, but on CUDA rank threads the autograd engine
runs every thread's nodes on one device thread, so a backward through
them there is refused (ROADMAP C15).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (_ambient_grid, gather_leaf,
                                      refuse_cuda_thread_backward)
from repro_torch.sharding.rules import for_grid, local_shard


def moe_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(tokens_per_group * top_k * capacity_factor / num_experts)
    return max(cap, top_k)


# ---------------------------------------------------------------------- #
# routing, dispatch and combine (shared by every path)
# ---------------------------------------------------------------------- #
class Routing:
    """One call's routing: the float32 router, top-k, the Switch aux
    loss and the group-local sort.  Shapes: ``[G, gs * k]`` for the
    sorted entries (``sorted_e``, ``pos``, ``keep``, ``token_of``,
    ``w_sorted``), ``[G, gs, k]`` for ``top_e`` / ``top_p``."""

    def __init__(self, x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 capacity_factor: float):
        g, gs, _ = x.shape
        e = router_w.shape[1]
        self.g, self.gs, self.e, self.k = g, gs, e, top_k
        self.cap = moe_capacity(gs, e, top_k, capacity_factor)
        logits = x.float() @ router_w.float()                 # [G, gs, E]
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.topk(probs, top_k, dim=-1)       # [G, gs, k]
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)       # renormalise
        self.top_e, self.top_p = top_e, top_p
        # load-balancing aux loss (Switch-style)
        me = probs.mean(dim=(0, 1))                           # [E]
        ce = F.one_hot(top_e, e).float().sum(dim=2).mean(dim=(0, 1))
        self.aux = e * (me * ce).sum() / top_k
        # group-local stable sort of the (token, expert) entries
        flat_e = top_e.reshape(g, gs * top_k)
        flat_w = top_p.reshape(g, gs * top_k).to(x.dtype)
        sort_idx = torch.argsort(flat_e, dim=1, stable=True)
        sorted_e = torch.gather(flat_e, 1, sort_idx)
        counts = torch.zeros((g, e), dtype=torch.long, device=x.device)
        counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, dim=1) - counts         # [G, E]
        pos = (torch.arange(gs * top_k, device=x.device)[None, :]
               - torch.gather(starts, 1, sorted_e))           # [G, gsk]
        self.sort_idx, self.sorted_e, self.pos = sort_idx, sorted_e, pos
        self.keep = pos < self.cap
        self.token_of = sort_idx // top_k
        self.w_sorted = torch.gather(flat_w, 1, sort_idx)


def _dispatch(x: torch.Tensor, r: Routing, expert: torch.Tensor,
              slot: torch.Tensor, mask: torch.Tensor, n_experts: int
              ) -> torch.Tensor:
    """The ``[G, n_experts, Cap, D]`` buffer: entry j of group g lands at
    ``(expert[g, j], slot[g, j])`` where ``mask`` holds; the others go to
    a sink row that is cut off (the reference's ``mode="drop"``)."""
    g, _, d = x.shape
    cap = r.cap
    x_sel = torch.gather(x, 1, r.token_of[..., None].expand(-1, -1, d))
    x_sel = torch.where(mask[..., None], x_sel, torch.zeros_like(x_sel))
    g_idx = torch.arange(g, device=x.device)[:, None]
    sink = g * n_experts * cap
    idx = torch.where(mask, (g_idx * n_experts + expert) * cap + slot,
                      torch.full_like(slot, sink))
    buf = x.new_zeros((sink + 1, d)).index_put(
        (idx.reshape(-1),), x_sel.reshape(-1, d))
    return buf[:sink].reshape(g, n_experts, cap, d)


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU experts over ``[G, E, Cap, D]`` (plain products)."""
    h = torch.einsum("gecd,edf->gecf", buf, w_gate)
    u = torch.einsum("gecd,edf->gecf", buf, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down)


def _combine(y: torch.Tensor, r: Routing, expert: torch.Tensor,
             slot: torch.Tensor, mask: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """Each token's weighted expert outputs (``y`` [G, n, Cap, D] read at
    ``(expert, slot)`` where ``mask`` holds, else 0), added in ascending
    expert id -- the order of the reference's sequential scatter-add, in
    the activation dtype, with no atomics."""
    g, n, cap, d = y.shape
    gs, k = r.gs, r.k
    g_idx = torch.arange(g, device=y.device)[:, None]
    flat = (g_idx * n + expert) * cap + torch.where(mask, slot,
                                                    torch.zeros_like(slot))
    y_tok = y.reshape(g * n * cap, d)[flat.reshape(-1)].reshape(g, gs * k, d)
    y_tok = torch.where(mask[..., None], y_tok, torch.zeros_like(y_tok))
    y_tok = y_tok * r.w_sorted[..., None]
    # sorted order -> (token, its k entries by ascending expert id): a
    # flat entry's sorted position, read for each token's slots in the
    # order of their expert ids
    inv = torch.argsort(r.sort_idx, dim=1)                   # flat -> sorted
    by_e = torch.argsort(r.top_e.reshape(g, gs, k), dim=-1)   # slots by expert
    order = torch.gather(inv.reshape(g, gs, k), 2, by_e)      # [G, gs, k]
    parts = torch.gather(
        y_tok, 1, order.reshape(g, gs * k)[..., None].expand(-1, -1, d)
    ).reshape(g, gs, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out.to(x.dtype)


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, gs, D]; router_w: [D, E]; w_gate/up: [E, D, F]; w_down:
    [E, F, D] (a tree's leaves cut over "data" gathered first).  Returns
    (out [G, gs, D], aux_loss scalar)."""
    w_gate, w_up, w_down = (gather_leaf(w) for w in (w_gate, w_up, w_down))
    r = Routing(x, router_w, top_k, capacity_factor)
    buf = _dispatch(x, r, r.sorted_e, r.pos, r.keep, r.e)
    y = _experts(buf, w_gate, w_up, w_down)
    return _combine(y, r, r.sorted_e, r.pos, r.keep, x), r.aux


# ---------------------------------------------------------------------- #
# autograd wrappers for the collectives of the model-axis / EP paths
# ---------------------------------------------------------------------- #
class _PsumGrad(torch.autograd.Function):
    """Forward identity, backward psum over ``comm``: an input that every
    rank of ``comm`` holds whole and uses for its own part of the work."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.psum(ct.contiguous()), None


class _Psum(torch.autograd.Function):
    """Forward psum over ``comm``, backward the cotangent itself: the
    partial sums' result is replicated over ``comm`` and so is its
    cotangent."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x.contiguous())

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _Pmean(torch.autograd.Function):
    """``pmean`` over ``comm`` both ways (the transpose of a psum over
    the ranks is a psum of their cotangents)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.psum(x.reshape(1))[0] / comm.size

    @staticmethod
    def backward(ctx, ct):
        return ctx.comm.psum(ct.reshape(1))[0] / ctx.comm.size, None


class _ScaleGrad(torch.autograd.Function):
    """Forward identity, backward ``ct * scale``: an output replicated
    over ranks that all differentiate it."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct * ctx.scale, None


def psum_grad(x, comm):
    return x if comm.size == 1 else _PsumGrad.apply(x, comm)


def psum(x, comm):
    return x if comm.size == 1 else _Psum.apply(x, comm)


def pmean(x, comm):
    return x if comm.size == 1 else _Pmean.apply(x, comm)


def scale_grad(x, scale: float):
    return x if scale == 1.0 else _ScaleGrad.apply(x, scale)


def expert_weights(grid, w_gate, w_up, w_down, ep_spec,
                   e_total: Optional[int] = None
                   ) -> Tuple[torch.Tensor, ...]:
    """This rank's experts: a tree's leaves cut over "data" first
    gathered just in time (``layers.gather_leaf``: the rank's real block,
    its gradient reduce-scattered back); then whole ``[E, ...]`` weights
    (``e_total`` of them; None: the weights are whole) cut over the
    expert axes (``ep_spec``) with ``local_shard``, or a rank's tree's
    ``[E / m, ...]`` taken as they stand.  Whole weights under a
    ``"model"`` axis among the expert axes first pass ``psum_grad`` over
    it, so that every model rank ends up with every expert's gradient,
    as the DP step does not sync over "model"."""
    axes = (ep_spec,) if isinstance(ep_spec, str) else tuple(ep_spec)
    out = []
    for w in (w_gate, w_up, w_down):
        w = gather_leaf(w)
        if e_total is None or w.shape[0] == e_total:
            if "model" in axes:
                w = psum_grad(w, grid.sub("model"))
            w = local_shard(w, (ep_spec,), grid)
        elif axes != ("model",):
            raise ValueError(f"a rank's {w.shape[0]} of {e_total} experts "
                             f"run over the model axis, not {axes}")
        out.append(w)
    return tuple(out)


# ---------------------------------------------------------------------- #
# the model axis: tokens replicated over "model", experts cut over it
# ---------------------------------------------------------------------- #
def _moe_local(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               capacity_factor: float, rank: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One model rank's part: route every token, run only the experts
    ``[rank * E_l, (rank + 1) * E_l)`` (``w_*`` hold those ``E_l``), and
    return the partial combine (zeros for the other ranks' experts) and
    the aux loss."""
    e_local = w_gate.shape[0]
    r = Routing(x, router_w, top_k, capacity_factor)
    local_e = r.sorted_e - rank * e_local
    mine = (local_e >= 0) & (local_e < e_local) & r.keep
    local_e = local_e.clamp(0, e_local - 1)
    buf = _dispatch(x, r, local_e, r.pos, mine, e_local)
    y = _experts(buf, w_gate, w_up, w_down)
    return _combine(y, r, local_e, r.pos, mine, x), r.aux


def moe_ffn_sharded(x, router_w, w_gate, w_up, w_down, *, top_k: int,
                    capacity_factor: float = 1.25):
    """The model-axis MoE when the ambient grid has a ``"model"`` axis;
    ``moe_ffn`` otherwise (no grid, single rank), and where the
    reference falls back: E not divisible by the model axis, or a batch
    the first DP axis does not divide.  ``x`` is this rank's rows (its
    block over the grid's DP axes), replicated over "model"."""
    grid = _ambient_grid()
    if grid is None or "model" not in grid.axis_names:
        return moe_ffn(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                       capacity_factor=capacity_factor)
    dp = for_grid(grid).data_axes
    m = grid.axis_size("model")
    n_dp = 1
    for a in dp:
        n_dp *= grid.axis_size(a)
    e_total = router_w.shape[1]
    local = w_gate.shape[0] != e_total
    if not local and (
            e_total % m != 0
            or (dp and (x.shape[0] * n_dp) % grid.axis_size(dp[0]) != 0)):
        return moe_ffn(x, router_w, w_gate, w_up, w_down, top_k=top_k,
                       capacity_factor=capacity_factor)
    if local and w_gate.shape[0] * m != e_total:
        raise ValueError(f"{w_gate.shape[0]} experts a rank of {e_total} "
                         f"over a model axis of {m}")
    refuse_cuda_thread_backward(x, grid, "moe_ffn_sharded")
    model = grid.sub("model")
    x = psum_grad(x, model)
    router_w = psum_grad(router_w, model)
    wg, wu, wd = expert_weights(grid, w_gate, w_up, w_down, "model",
                                e_total)
    out, aux = _moe_local(x, router_w, wg, wu, wd, top_k=top_k,
                          capacity_factor=capacity_factor,
                          rank=model.rank)
    for a in dp:
        aux = pmean(aux, grid.sub(a))
    # the combine: each rank contributed its experts' tokens
    return psum(out, model), scale_grad(aux, 1.0 / m)


__all__ = ["moe_capacity", "moe_ffn", "moe_ffn_sharded"]
