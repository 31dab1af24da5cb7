"""Transformer primitives: RMSNorm, rotary embeddings, GQA attention
(direct and chunked), the SwiGLU MLP and the GELU MLP (counterparts of
the functions with the same names in ``repro/models/layers.py``).

Conventions kept from the reference:

* ``rms_norm`` computes in float32 and scales by ``(1 + weight)``, so a
  zero-initialised norm weight is the identity scale;
* RoPE is the half-split form: the first and second halves of the head
  dimension form the rotated pairs (not interleaved even/odd lanes).

Attention keeps the reference's dispatch: a self-attention longer than
``_CHUNK_THRESHOLD`` without ``kv_len`` takes the online-softmax chunked
path, everything else (short sequences, decode over a cache) the direct
one.  Where the reference's chunked path is the jnp twin of its Pallas
flash kernel, the port's kernel route on a CUDA tensor calls that
kernel's port (``kernels.ops.flash_attention``) on the unexpanded K/V;
the plain route, and any CPU tensor, take ``_chunked_attention``,
differentiated by autograd.

The model axis: where the reference reads the ambient mesh, the port
reads this thread's ambient grid (:func:`ambient_grid`, a context
manager binding the rank's ``GridComm``; per thread, since the ranks of
``run_local_grid`` are threads of one process).  Under a grid with a
``"model"`` axis, ``swiglu`` runs the fused tensor-parallel
down-projection (``set_fused_tp``) and a dense decode over a
sequence-sharded KV cache runs ``flash_decode``.  Two trees run there:

* a whole tree (every weight replicated over "model"): each rank
  computes everything but the fused down-projection's ring;
* one rank's shards (``sharding.rules.shard_params``): the tensor-
  parallel block.  The entry points bind the model axis
  (:func:`model_parallel`, :func:`tree_comms` reading the tree's
  shapes), and each column-parallel input passes :func:`copy_to_model`
  (identity forward, all-reduce of the cotangent backward), each
  row-parallel output :func:`reduce_from_model` (the engine's
  ``allreduce``, the cotangent passed through).  Attention runs on the
  heads its weights hold, SwiGLU on its block of the hidden dim.

A tree cut over "data" too (ZeRO-3, ``shard_params(...,
data_cut=True)``): the entry points bind the data axis and each leaf's
cut dim (:func:`model_parallel`, from ``sharding.rules.tree_cuts``), and
each layer loop gathers the layer's leaves over "data" just before it
runs them (:func:`gather_layer`, :class:`_GatherFromData`: the engine's
allgather forward, its reduce-scatter of the cotangent backward, divided
by the data size: the DP step's mean).  The MoE's expert weights are
gathered inside the MoE body instead (``moe.expert_weights``).

The reduction of a backward runs inside an autograd node: fine on the
CPU and one process a rank; on CUDA rank threads the autograd engine
runs every thread's nodes on one device thread, so such a backward is
refused (:func:`refuse_cuda_thread_backward`, ROADMAP C15).  The
reference's sharding hints (``shard_hint``) steer GSPMD and have no
counterpart.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels.ref import FLASH_CHUNK

_CHUNK_THRESHOLD = 2048  # direct attention below this sequence length

IntLike = Union[int, torch.Tensor]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S])."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # [D/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs             # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    if group == 1:
        return k
    return k.repeat_interleave(group, dim=1)


def _direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, window: Optional[int],
                      q_offset: IntLike = 0,
                      kv_len: Optional[IntLike] = None,
                      probs_bf16: bool = False) -> torch.Tensor:
    """q: [B, H, Sq, D]; k/v: [B, H, Skv, D] (already GQA-expanded).
    The logits are the float32 product of the inputs (bf16 products are
    exact in float32: the reference's native-dtype matmul with float32
    accumulation)."""
    _, _, sq, d = q.shape
    skv = k.shape[2]
    scale = 1.0 / (d ** 0.5)
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    q_ids = q_offset + torch.arange(sq, device=q.device)[:, None]
    k_ids = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_ids <= q_ids
    if window is not None:
        mask &= k_ids > q_ids - window
    if kv_len is not None:
        mask &= k_ids < kv_len
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), torch.zeros_like(probs), probs)
    if probs_bf16:
        # bf16 operands, float32 products and sums, a bf16 result
        out = (probs.to(torch.bfloat16).float()
               @ v.to(torch.bfloat16).float()).to(torch.bfloat16)
    else:
        out = probs @ v.float()
    return out.to(q.dtype)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int],
                       chunk: int = FLASH_CHUNK,
                       probs_bf16: bool = False) -> torch.Tensor:
    """Online-softmax attention scanning KV chunks; never materialises
    S x S logits.  q: [B, H, S, D]; k/v: [B, H, S, D] (GQA-expanded).

    Under autograd each chunk step is checkpointed (non-reentrant
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``): the
    backward recomputes the chunk's logits instead of saving them."""
    b, h, s, d = q.shape
    scale = 1.0 / (d ** 0.5)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunked attention: sequence {s} is not a "
                         f"multiple of the KV chunk {chunk}")
    qf = q.float() * scale
    q_ids = torch.arange(s, device=q.device)

    def step(m, l, acc, k0: int, kb, vb):
        k_ids = k0 + torch.arange(chunk, device=q.device)
        logits = qf @ kb.float().transpose(-1, -2)
        mask = torch.ones((s, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_ids[None, :] <= q_ids[:, None]
        if window is not None:
            mask &= k_ids[None, :] > q_ids[:, None] - window
        logits = logits.masked_fill(~mask, float("-inf"))
        m_cur = logits.amax(dim=-1)
        m_new = torch.maximum(m, m_cur)
        safe_m = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp((logits - safe_m[..., None]).masked_fill(
            ~mask, float("-inf")))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                           torch.zeros_like(m))
        l_new = l * corr + p.sum(dim=-1)
        if probs_bf16:
            pv = (p.to(torch.bfloat16).float()
                  @ vb.to(torch.bfloat16).float()).to(torch.bfloat16).float()
        else:
            pv = p @ vb.float()
        return m_new, l_new, acc * corr[..., None] + pv

    m = torch.full((b, h, s), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for k0 in range(0, s, chunk):
        args = (m, l, acc, k0, k[:, :, k0:k0 + chunk], v[:, :, k0:k0 + chunk])
        if torch.is_grad_enabled():
            m, l, acc = checkpoint(step, *args, use_reentrant=False)
        else:
            m, l, acc = step(*args)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: IntLike = 0, kv_len: Optional[IntLike] = None,
              probs_bf16: bool = False,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
    """GQA attention.  q: [B, Sq, H, D]; k/v: [B, Skv, Hkv, D].  Returns
    [B, Sq, H, D].

    ``use_kernel`` picks the chunked branch's route: the kernel route
    (``True``, or ``None`` on a CUDA tensor) launches the flash kernel on
    a CUDA tensor (its shape-only body on a meta one,
    ``ops.on_card_route``); the plain route (``False``, or ``None`` on the
    CPU) and every CPU tensor take the plain chunked path.  The kernel
    does not round the probabilities to bf16, so ``probs_bf16`` on the
    kernel route raises."""
    _, sq, h, _ = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qt = q.transpose(1, 2)                             # [B, H, Sq, D]
    kt = k.transpose(1, 2)                             # [B, Hkv, Skv, D]
    vt = v.transpose(1, 2)
    skv = kt.shape[2]
    if sq == skv and sq > _CHUNK_THRESHOLD and kv_len is None:
        if sq % min(FLASH_CHUNK, sq):
            raise ValueError(f"attention: sequence {sq} is not a multiple "
                             f"of the KV chunk {FLASH_CHUNK}")
        on_card = ops.on_card_route(q)
        if use_kernel is None:
            use_kernel = on_card
        if use_kernel and probs_bf16:
            raise NotImplementedError(
                "attention: probs_bf16 rounds the probabilities to bf16 "
                "before P V, which the flash kernel does not do; a kernel "
                "variant for it is ROADMAP.md C11")
        if use_kernel and on_card:
            out = ops.flash_attention(qt, kt, vt, causal=causal,
                                      window=window)
        else:
            out = _chunked_attention(qt, _repeat_kv(kt, group),
                                     _repeat_kv(vt, group), causal, window,
                                     probs_bf16=probs_bf16)
    else:
        out = _direct_attention(qt, _repeat_kv(kt, group),
                                _repeat_kv(vt, group), causal, window,
                                q_offset=q_offset, kv_len=kv_len,
                                probs_bf16=probs_bf16)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------- #
# the ambient grid: this thread's rank of a grid with named axes
# ---------------------------------------------------------------------- #
_AMBIENT = threading.local()


@contextlib.contextmanager
def ambient_grid(grid) -> Iterator:
    """Bind ``grid`` (this rank's ``GridComm``) as the thread's ambient
    grid for the duration of the block, the counterpart of entering a
    mesh; blocks nest, and ``None`` unbinds."""
    prev = getattr(_AMBIENT, "grid", None)
    _AMBIENT.grid = grid
    try:
        yield grid
    finally:
        _AMBIENT.grid = prev


def _ambient_grid():
    """The grid this thread is bound to, or None."""
    return getattr(_AMBIENT, "grid", None)


# ---------------------------------------------------------------------- #
# tensor parallelism over "model" on a tree of one rank's shards
# ---------------------------------------------------------------------- #
def tree_comms(params, cfg):
    """(the model axis's ``Comm`` when ``params`` is one rank's shards,
    else None; (the data axis's ``Comm``, {id(leaf): its cut dim}) when
    the tree is cut over "data" too, else None; the tree's
    ``sharding.rules.Cuts``), by ``sharding.rules.tree_cuts`` under the
    thread's ambient grid, whose model axis must be the one the tree was
    cut for."""
    from repro_torch.sharding.rules import tree_cuts
    from repro_torch.tree import tree_leaves

    grid = _ambient_grid()
    cuts = tree_cuts(params, cfg, grid)
    m = cuts.model
    if m > 1 and (grid is None or "model" not in grid.axis_names
                  or grid.axis_size("model") != m):
        have = None if grid is None else dict(zip(grid.axis_names,
                                                  grid.shape))
        raise ValueError(
            f"{cfg.name}: a tree cut over a model axis of {m} runs under a "
            f"grid with that axis (ambient_grid), not {have}")
    data = None
    if cuts.data > 1:
        data = (grid.sub("data"), {
            id(x): dim for x, dim in zip(tree_leaves(params),
                                         cuts.data_dims) if dim is not None})
    return (grid.sub("model") if m > 1 else None), data, cuts


def _tp():
    """The model axis this thread's entry point bound, or None."""
    return getattr(_AMBIENT, "tp", None)


@contextlib.contextmanager
def bind_tp(comm) -> Iterator:
    """Bind ``comm`` as the thread's tensor-parallel model axis (None:
    a whole tree) for the duration of the block."""
    prev = getattr(_AMBIENT, "tp", None)
    _AMBIENT.tp = comm
    try:
        yield comm
    finally:
        _AMBIENT.tp = prev


def _data_cut():
    """(data axis, {id(leaf): dim}) this thread's entry point bound for a
    tree cut over "data", or None."""
    return getattr(_AMBIENT, "data_cut", None)


@contextlib.contextmanager
def bind_data(cut) -> Iterator:
    """Bind ``cut`` (:func:`_data_cut`'s pair, or None) for the block."""
    prev = getattr(_AMBIENT, "data_cut", None)
    _AMBIENT.data_cut = cut
    try:
        yield cut
    finally:
        _AMBIENT.data_cut = prev


@contextlib.contextmanager
def model_parallel(params, cfg) -> Iterator:
    """What an entry point runs under: the model axis of ``params`` and
    its data cut (:func:`tree_comms`) bound for the block; yields the
    model axis (or None).  An entry point called inside another's block
    on the same ``params`` keeps that binding: the tree is read once."""
    outer = getattr(_AMBIENT, "params", None)
    if outer is params:
        yield _tp()
        return
    comm, data, _ = tree_comms(params, cfg)
    _AMBIENT.params = params
    try:
        with bind_tp(comm), bind_data(data):
            yield comm
    finally:
        _AMBIENT.params = outer


def refuse_cuda_thread_backward(x: torch.Tensor, grid, what: str) -> None:
    """A backward through a collective on CUDA rank threads would run it
    on the autograd engine's one device thread and deadlock (ROADMAP
    C15): refuse it.  One process a rank (``ProcessGroupGrid``) has its
    own device thread, and the CPU runs each caller's backward."""
    from repro_torch.collectives.comm import LocalGridComm, LocalComm

    local = isinstance(grid, (LocalGridComm, LocalComm))
    if (torch.is_grad_enabled() and x.device.type == "cuda" and local
            and grid.size > 1):
        raise NotImplementedError(
            f"{what}: a backward through its collectives on CUDA rank "
            f"threads would run them on the autograd engine's one device "
            f"thread (ROADMAP.md C15); run forward-only (torch.no_grad) "
            f"or one process a rank")


def _engine(comm):
    from repro_torch.collectives.api import get_engine
    return get_engine(device=comm.device)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced over the model axis:
    the input of a column-parallel product, whole on every rank, each
    using it for its own block."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _engine(ctx.comm).allreduce(ct.contiguous(), ctx.comm), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums of a row-parallel product all-reduced over the
    model axis (the engine's ``allreduce``); the result is whole on every
    rank and so is its cotangent, which passes through."""

    @staticmethod
    def forward(ctx, x, comm):
        return _engine(comm).allreduce(x.contiguous(), comm)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's block of the last dim, gathered; the backward takes
    this rank's block of the (whole) cotangent."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.n = comm, x.shape[-1]
        parts = _engine(comm).allgather(x.contiguous()[None], comm)
        return torch.cat(list(parts), dim=-1)

    @staticmethod
    def backward(ctx, ct):
        return ct.narrow(-1, ctx.comm.rank * ctx.n, ctx.n), None


class _GatherFromData(torch.autograd.Function):
    """A leaf's blocks gathered over the data axis along ``dim`` (the
    engine's allgather); the backward reduce-scatters the cotangent over
    the axis (the engine's reduce-scatter) and divides it by the axis
    size: each rank's block gets the mean of the ranks' gradients, the DP
    step's mean, so the leaf needs no allreduce over "data"."""

    @staticmethod
    def forward(ctx, w, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        whole = _engine(comm).allgather(w.movedim(dim, 0).contiguous(), comm)
        return whole.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, ct):
        comm, dim = ctx.comm, ctx.dim
        g = _engine(comm).reduce_scatter(ct.movedim(dim, 0).contiguous(),
                                         comm)
        return (g / comm.size).movedim(0, dim).contiguous(), None, None


#: leaves the MoE body gathers itself (``moe.expert_weights``)
_EXPERT_LEAVES = ("eg", "eu", "ed")


def gather_leaf(w: torch.Tensor) -> torch.Tensor:
    """``w`` whole over "data": gathered (:class:`_GatherFromData`) when
    it is a leaf of the bound tree cut over "data", else ``w`` itself."""
    cut = _data_cut()
    dim = None if cut is None else cut[1].get(id(w))
    if dim is None:
        return w
    comm = cut[0]
    if torch.is_grad_enabled() and w.requires_grad:
        refuse_cuda_thread_backward(w, comm, "the tree cut over data")
    return _GatherFromData.apply(w, comm, dim)


def gather_layer(tree, name: str = ""):
    """A layer's leaves whole over "data" (:func:`gather_leaf`), but the
    expert weights, which the MoE body gathers; the tree itself when no
    data cut is bound."""
    if _data_cut() is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_layer(v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_layer(v, name) for v in tree)
    return tree if name in _EXPERT_LEAVES else gather_leaf(tree)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """:class:`_CopyToModel` over the bound model axis (identity without
    one)."""
    comm = _tp()
    if comm is None or comm.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        refuse_cuda_thread_backward(x, comm, "the tensor-parallel block")
        return _CopyToModel.apply(x, comm)
    return x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """:class:`_ReduceFromModel` over the bound model axis."""
    comm = _tp()
    if comm is None or comm.size == 1:
        return x
    return _ReduceFromModel.apply(x, comm)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """:class:`_GatherFromModel` over the bound model axis."""
    comm = _tp()
    if comm is None or comm.size == 1:
        return x
    return _GatherFromModel.apply(x, comm)


# ---------------------------------------------------------------------- #
# sequence-parallel flash decode
#
# GQA archs whose kv-head count doesn't divide the model axis keep their
# KV cache *sequence*-sharded (sharding.rules._kv_cache_spec).  Each
# model rank computes flash partials (m, l, acc) over its local cache
# block, and the ranks combine them with a log-sum-exp merge: the exact
# max over an allgather of the [B, H, 1] maxima, then two sums through
# the engine, instead of gathering the cache.
# ---------------------------------------------------------------------- #
def flash_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 kv_len: IntLike, grid) -> torch.Tensor:
    """q: [B, 1, H, D] (replicated over "model"); ck / cv: [B, S / P, KV,
    D], this rank's sequence block of the cache (rank r holds positions
    ``[r S / P, (r + 1) S / P)``); positions ``>= kv_len`` are masked.
    Returns [B, 1, H, D] on every rank of the model axis."""
    from repro_torch.collectives.api import get_engine

    eng = get_engine(device=grid.device)
    comm = grid.sub("model")
    _, _, h, d = q.shape
    group = h // ck.shape[2]
    s_local = ck.shape[1]
    offset = comm.rank * s_local
    kt = _repeat_kv(ck.transpose(1, 2), group)          # [B, H, S_l, D]
    vt = _repeat_kv(cv.transpose(1, 2), group)
    qt = q.transpose(1, 2)                              # [B, H, 1, D]
    logits = (qt.float() @ kt.float().transpose(-1, -2)) / (d ** 0.5)
    ids = offset + torch.arange(s_local, device=q.device)
    mask = ids < kv_len
    logits = logits.masked_fill(~mask, float("-inf"))
    m_l = logits.amax(dim=-1)                           # [B, H, 1]
    m_g = eng.allgather_inside(m_l[None], comm).amax(dim=0)
    safe = torch.where(torch.isfinite(m_g), m_g, torch.zeros_like(m_g))
    p = torch.exp((logits - safe[..., None]).masked_fill(~mask,
                                                         float("-inf")))
    l_g = eng.allreduce_inside(p.sum(dim=-1), comm)
    acc_g = eng.allreduce_inside(p @ vt.float(), comm)
    l_g = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    out = (acc_g / l_g[..., None]).to(q.dtype)
    return out.transpose(1, 2)                          # [B, 1, H, D]


def use_flash_decode(b: int, sq: int, skv: int, kvh: int):
    """The ambient grid when the sequence-parallel decode applies: one
    query position, a "model" axis whose size divides the global cache
    length ``skv`` but not the kv-head count (head-sharded caches take
    the regular path)."""
    grid = _ambient_grid()
    if grid is None or sq != 1 or "model" not in grid.axis_names:
        return None
    m = grid.axis_size("model")
    if kvh % m == 0 or skv % m != 0:
        return None
    return grid


# ---------------------------------------------------------------------- #
# fused tensor-parallel down-projection (opt-in)
#
# The TP down-projection contracts the model-sharded hidden dim, so its
# natural lowering is a partial sum + psum.  With fusion enabled the
# psum is a reduce-scatter + allgather and the reduce-scatter rides the
# engine's fused matmul + reduce-scatter ring: the ``matmul_tiled``
# kernel computes each row block between the ring's hops.
# ---------------------------------------------------------------------- #
_FUSED_TP = False


def set_fused_tp(value: bool) -> None:
    """Enable/disable the fused TP down-projection (launchers flip this
    under ``--fused``; a no-op unless the ambient grid has a model axis
    > 1 and the shapes tile the ring)."""
    global _FUSED_TP
    _FUSED_TP = bool(value)


def fused_tp_enabled() -> bool:
    return _FUSED_TP


def _fused_tp_applicable(grid, h: torch.Tensor) -> bool:
    """``h`` [B, S, F] holds this rank's rows (its DP block of the
    batch): the ring needs a model axis > 1 that divides F and the rows
    B * S -- the reference's test on ``(B / n_dp) * S`` when the batch is
    split over DP."""
    if "model" not in grid.axis_names or grid.axis_size("model") <= 1:
        return False
    pm = grid.axis_size("model")
    b, s, f = h.shape
    return f % pm == 0 and (b * s) % pm == 0


class _FusedDownProj(torch.autograd.Function):
    """``psum(h_r @ w_down_r)`` over "model" as the fused ring's
    reduce-scatter + an allgather, rank r taking block r of h's hidden
    dim and of ``w_down``'s rows.

    The backward is the dense one on the full tensors, ``dh = dy @
    w_downᵀ`` and ``dw = hᵀ @ dy``, with no collective: the weights are
    replicated over "model" and so is dy.  A collective in a backward
    node could deadlock on CUDA, where the autograd engine runs the
    nodes of every thread's backward on one worker thread per device;
    nothing here reads the thread's ambient grid in the backward."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, w_down: torch.Tensor, grid,
                local: bool) -> torch.Tensor:
        from repro_torch.collectives.api import get_engine

        eng = get_engine(device=grid.device)
        comm = grid.sub("model")
        b, s, f = h.shape
        if local:
            # a rank's shards: h and w_down are already its blocks
            x2, w = h.reshape(b * s, f).contiguous(), w_down
        else:
            fl = f // comm.size
            cols = slice(comm.rank * fl, (comm.rank + 1) * fl)
            # a contiguous block: matmul_tiled's TMA variant wants
            # 16-byte aligned rows, which a strided column view does not
            # have
            x2 = h[..., cols].reshape(b * s, fl).contiguous()
            w = w_down[cols]
        y_s = eng.fused_matmul_reduce_scatter(x2, w, comm)
        y = eng.allgather_inside(y_s, comm)
        ctx.save_for_backward(h, w_down)
        return y.reshape(b, s, w_down.shape[-1])

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        h, w_down = ctx.saved_tensors
        d = w_down.shape[-1]
        dh = dy @ w_down.t()
        dw = h.reshape(-1, h.shape[-1]).t() @ dy.reshape(-1, d)
        return dh, dw, None, None


def _fused_down_proj(h: torch.Tensor, w_down: torch.Tensor, grid,
                     local: bool = False) -> torch.Tensor:
    """``h @ w_down`` as ``psum`` over "model" of the ranks' blocks, the
    reduce-scatter fused with the GEMM ring (:class:`_FusedDownProj`).
    ``local``: ``h`` and ``w_down`` are this rank's blocks (a tree of
    shards), taken as they stand."""
    return _FusedDownProj.apply(h, w_down, grid, local)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP; on a tree of shards (a bound model axis) the
    column-parallel gate and up projections and the row-parallel down
    projection on this rank's block of the hidden dim, reduced over
    "model" (through the fused ring under ``set_fused_tp``)."""
    if _tp() is not None:
        h = F.silu(copy_to_model(x) @ w_gate) * (copy_to_model(x) @ w_up)
        grid = _ambient_grid()
        b, s, _ = h.shape
        if _FUSED_TP and (b * s) % _tp().size == 0:
            return _fused_down_proj(h, w_down, grid, local=True)
        return reduce_from_model(h @ w_down)
    h = F.silu(x @ w_gate) * (x @ w_up)
    if _FUSED_TP:
        grid = _ambient_grid()
        if grid is not None and _fused_tp_applicable(grid, h):
            return _fused_down_proj(h, w_down, grid)
    return h @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """The biased MLP with tanh-approximated GELU (the reference exports
    it; no model path calls it: its encoder-decoder uses ``swiglu``)."""
    h = F.gelu(x @ w_up + b_up, approximate="tanh")
    return h @ w_down + b_down


__all__ = ["ambient_grid", "apply_rope", "attention", "bind_data",
           "bind_tp", "copy_to_model", "flash_decode", "fused_tp_enabled",
           "gather_from_model", "gather_layer", "gather_leaf", "gelu_mlp",
           "model_parallel", "reduce_from_model",
           "refuse_cuda_thread_backward", "rms_norm", "rope_frequencies",
           "set_fused_tp", "swiglu", "tree_comms",
           "use_flash_decode"]
