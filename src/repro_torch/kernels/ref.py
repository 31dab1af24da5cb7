"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written kernel computes, with the
same algorithm as the reference oracle of the same name in
``repro/kernels/ref.py``.  The CPU path of ``repro_torch.kernels.ops``
runs these; on the GPU they are the yardstick the kernels are held
against.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def multi_add_ref(stacked: torch.Tensor) -> torch.Tensor:
    """K-way fused accumulate: [K, N] partials -> [N], the sum over the
    leading axis taken in float32, row 0 first, then rows 1..K-1 in
    order (the CUDA kernel's order; the reference oracle leaves the
    order to XLA), stored in the input dtype."""
    acc = stacked[0].float()
    for row in stacked[1:]:
        acc = acc + row.float()
    return acc.to(stacked.dtype)


def matmul_tiled_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M, K] @ [K, N] -> [M, N]``: the product of the inputs cast to
    float32, in x's dtype (the Pallas kernel's ``jnp.dot`` with float32
    accumulation).  Differentiable: autograd gives the reference's dense
    backward."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def fused_matmul_rs_ref(x_parts: torch.Tensor, w_parts: torch.Tensor
                        ) -> torch.Tensor:
    """Fused matmul + reduce-scatter oracle.

    ``x_parts``: [P, M, K_loc] per-rank activations; ``w_parts``:
    [P, K_loc, N] per-rank weight shards (K sharded over the axis).
    Returns [P, M/P, N]: slot ``i`` is rank ``i``'s row block of the
    summed product, accumulated in float32."""
    p, m, _ = x_parts.shape
    n = w_parts.shape[-1]
    full = torch.einsum("pmk,pkn->mn", x_parts.float(), w_parts.float())
    return full.reshape(p, m // p, n).to(x_parts.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Block-indexed decode attention over a paged KV cache.

    ``q``: [B, H, D] single-position queries; ``k_pages``/``v_pages``:
    [N, bs, Hkv, D] physical block pool; ``block_tables``: [B, M] int32
    per-request block ids (logical order); ``lengths``: [B] int32 valid
    context per request.  Returns [B, H, D].  Supports GQA.  A row of
    length 0 is all-masked and gives NaN, as the reference oracle does.
    """
    n, bs, hkv, d = k_pages.shape
    b, h, _ = q.shape
    m = block_tables.shape[1]
    group = h // hkv
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=q.device)[None, None, :]
           ).reshape(b, m * bs)
    k = k_pages.reshape(n * bs, hkv, d)[idx]           # [B, S, Hkv, D]
    v = v_pages.reshape(n * bs, hkv, d)[idx]
    kf = k.transpose(1, 2).float().repeat_interleave(group, dim=1)
    vf = v.transpose(1, 2).float().repeat_interleave(group, dim=1)
    qf = q.float() / (d ** 0.5)
    logits = torch.einsum("bhd,bhkd->bhk", qf, kf)
    mask = (torch.arange(m * bs, device=q.device)[None, None, :]
            < lengths[:, None, None])
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs, vf)
    return out.to(q.dtype)


def paged_attention_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor,
                              split_blocks: int) -> torch.Tensor:
    """``paged_attention_ref`` computed as the CUDA kernel splits it: split
    ``s`` of a request attends over its logical blocks ``[s *
    split_blocks, (s + 1) * split_blocks)`` below the length, giving a
    float32 partial (max m, denominator l, unnormalised accumulator); the
    partials merge in split order with weights exp(m_s - max m), a split
    without a token (m = -inf) weighing 0 as the reference's ``corr``
    does.  A length-0 row gives zeros, as the kernels do.  For tests and
    ``chip_smoke.py``; the serving path never calls it."""
    n, bs, hkv, d = k_pages.shape
    b, h, _ = q.shape
    m = block_tables.shape[1]
    n_split = -(-m // split_blocks)
    span = split_blocks * bs
    s_pad = n_split * span
    idx = (block_tables.long()[:, :, None] * bs
           + torch.arange(bs, device=q.device)[None, None, :]
           ).reshape(b, m * bs)
    k = k_pages.reshape(n * bs, hkv, d)[idx].transpose(1, 2).float()
    v = v_pages.reshape(n * bs, hkv, d)[idx].transpose(1, 2).float()
    k = k.repeat_interleave(h // hkv, dim=1)           # [B, H, S, D]
    v = v.repeat_interleave(h // hkv, dim=1)
    live = (torch.arange(m * bs, device=q.device)[None, :]
            < lengths.clamp(min=0)[:, None])           # [B, S]
    logits = torch.einsum("bhd,bhkd->bhk", q.float() / (d ** 0.5), k)
    logits = logits.masked_fill(~live[:, None], float("-inf"))
    v = v.masked_fill(~live[:, None, :, None], 0.0)
    pad = s_pad - m * bs
    logits = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    logits = logits.reshape(b, h, n_split, span)
    v = v.reshape(b, h, n_split, span, d)
    m_s = logits.amax(-1)                              # [B, H, n_split]
    p = torch.exp(logits - torch.where(torch.isfinite(m_s), m_s,
                                       torch.zeros_like(m_s))[..., None])
    l_s = p.sum(-1)
    acc_s = torch.einsum("bhst,bhstd->bhsd", p, v)
    m_all = m_s.amax(-1, keepdim=True)
    w = torch.where(torch.isfinite(m_s), torch.exp(m_s - m_all),
                    torch.zeros_like(m_s))
    den = torch.zeros_like(m_all[..., 0])
    num = torch.zeros_like(acc_s[:, :, 0])
    for s in range(n_split):                           # the kernel's order
        den = den + l_s[:, :, s] * w[:, :, s]
        num = num + acc_s[:, :, s] * w[:, :, s, None]
    out = torch.where(den[..., None] > 0, num / den[..., None],
                      torch.zeros_like(num))
    return out.to(q.dtype)


#: the reference's attention chunk (``_KV_CHUNK`` of
#: ``repro/models/layers.py``): the KV chunk of the plain chunked
#: attention and the query and key chunk of the flash kernel's plain
#: versions, which bounds their float32 logits to [B, H, 1024, S]
#: (forward) and [B, H, 1024, 1024] (backward), never S x S
FLASH_CHUNK = 1024


def _flash_mask(q0: int, nq: int, k0: int, nk: int, causal: bool,
                window: Optional[int], device) -> Optional[torch.Tensor]:
    """[nq, nk] mask of the query rows q0.. and key columns k0.. (None:
    nothing is masked)."""
    if not causal and window is None:
        return None
    q_ids = torch.arange(q0, q0 + nq, device=device)[:, None]
    k_ids = torch.arange(k0, k0 + nk, device=device)[None, :]
    mask = torch.ones((nq, nk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_ids <= q_ids
    if window is not None:
        mask &= k_ids > q_ids - window
    return mask


def _pair_needed(q0: int, q1: int, k0: int, k1: int, causal: bool,
                 window: Optional[int]) -> bool:
    """Whether any (query in [q0, q1), key in [k0, k1)) pair is unmasked:
    the Pallas kernel's tile skip (``flash_attention.py:45-50``)."""
    needed = True
    if causal:
        needed &= k0 <= q1 - 1
    if window is not None:
        needed &= k1 - 1 > q0 - window
    return needed


def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, H, S, D] -> [B, Hkv, G, S, D]: query head h reads KV head
    h // G, as the Pallas kernel's ``kv_index`` does."""
    b, h, s, d = q.shape
    return q.reshape(b, hkv, h // hkv, s, d)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention ``[B, H, S, D] x [B, Hkv, S, D] -> [B, H, S, D]`` with
    GQA (H a multiple of Hkv), causal masking and an optional sliding
    window, as ``repro/kernels/ref.py::flash_attention_ref``; also
    returns the float32 row log-sum-exp ``lse`` [B, H, S] of the scaled
    logits, which the backward needs.

    Float32 throughout: q is cast, then scaled by 1/sqrt(D) (the Pallas
    kernel's order), the output cast to q's dtype.  Query rows go in
    chunks of ``FLASH_CHUNK`` against every key.  A row whose keys are
    all masked gives output 0 and lse -inf (the Pallas ``_finalize``
    guard).  Differentiable by autograd."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qg = _grouped(q, hkv).float() * scale               # [B, Hkv, G, S, D]
    kf = k.float()[:, :, None]                          # [B, Hkv, 1, S, D]
    vf = v.float()[:, :, None]
    outs, lses = [], []
    for q0 in range(0, s, FLASH_CHUNK):
        nq = min(FLASH_CHUNK, s - q0)
        logits = qg[:, :, :, q0:q0 + nq] @ kf.transpose(-1, -2)
        mask = _flash_mask(q0, nq, 0, s, causal, window, q.device)
        if mask is not None:
            # a row with no key left keeps finite logits, so that neither
            # lse nor its gradient is NaN; its probabilities are zeroed
            live = mask.any(dim=-1, keepdim=True)
            logits = logits.masked_fill(~mask & live, float("-inf"))
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.exp(logits - lse[..., None])
        if mask is not None:
            probs = probs.masked_fill(~mask, 0.0)
            lse = lse.masked_fill(~live[:, 0], float("-inf"))
        outs.append(probs @ vf)
        lses.append(lse)
    out = torch.cat(outs, dim=3).reshape(b, h, s, d)
    return out.to(q.dtype), torch.cat(lses, dim=3).reshape(b, h, s)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor,
                            causal: bool = True,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Gradients (dq, dk, dv), float32, of ``flash_attention_ref``'s
    output from its saved output ``o`` and row log-sum-exp ``lse``.

    The flash-attention backward in plain PyTorch: over (query chunk, key
    chunk) pairs of ``FLASH_CHUNK``, skipping pairs the mask empties, it
    recomputes ``P = exp(scale * Q K^T - lse)`` and accumulates
    ``dV += P^T dO``, ``dS = P * (dO V^T - rowsum(dO * O))``,
    ``dQ += scale * dS K`` and ``dK += scale * dS^T Q``, never holding
    S x S: what autodiff of the reference's checkpointed chunk step
    (``repro/models/layers.py::_chunked_attention``) computes.  dK and dV
    sum over the query heads of each GQA group.  Rows with every key
    masked (lse -inf) get zero gradient."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qg = _grouped(q, hkv).float()                       # [B, Hkv, G, S, D]
    dog = _grouped(do, hkv).float()
    kf, vf = k.float(), v.float()                       # [B, Hkv, S, D]
    lse_g = lse.float().reshape(b, hkv, h // hkv, s)
    delta = (dog * _grouped(o, hkv).float()).sum(-1)    # [B, Hkv, G, S]
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, s, FLASH_CHUNK):
        q1 = min(q0 + FLASH_CHUNK, s)
        qc = qg[:, :, :, q0:q1]
        doc = dog[:, :, :, q0:q1]
        lc = lse_g[:, :, :, q0:q1, None]
        for k0 in range(0, s, FLASH_CHUNK):
            k1 = min(k0 + FLASH_CHUNK, s)
            if not _pair_needed(q0, q1, k0, k1, causal, window):
                continue
            kc = kf[:, :, None, k0:k1]                  # [B, Hkv, 1, c, D]
            vc = vf[:, :, None, k0:k1]
            logits = (qc @ kc.transpose(-1, -2)) * scale
            keep = torch.isfinite(lc)
            mask = _flash_mask(q0, q1 - q0, k0, k1 - k0, causal, window,
                               q.device)
            if mask is not None:
                keep = keep & mask
            p = torch.where(keep, torch.exp(logits - lc),
                            torch.zeros_like(logits))
            dv[:, :, k0:k1] += (p.transpose(-1, -2) @ doc).sum(2)
            dp = doc @ vc.transpose(-1, -2)
            ds = p * (dp - delta[:, :, :, q0:q1, None])
            dq[:, :, :, q0:q1] += (ds @ kc) * scale
            dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qc).sum(2) * scale
    return dq.reshape(b, h, s, d), dk, dv


def selective_scan_ref(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-1 selective scan as the plain sequential recurrence
    (float32 throughout)::

        h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t
        y_t = <h_t, C_t>

    dt/x: [B, S, D]; b/c: [B, S, N]; a: [D, N]; h0: [B, D, N].  Returns
    (y [B, S, D] in x.dtype, h_final [B, D, N] float32).  The plain
    version of all three scan kernels: its gradient, by autograd, is what
    the backward kernel computes."""
    dt32, x32, b32, c32 = (t.float() for t in (dt, x, b, c))
    a32 = a.float()
    h = h0.float()
    ys = []
    for t in range(dt.shape[1]):
        a_bar = torch.exp(dt32[:, t, :, None] * a32)           # [B, D, N]
        b_bar = (dt32[:, t] * x32[:, t])[:, :, None] * b32[:, t, None, :]
        h = a_bar * h + b_bar
        ys.append((h * c32[:, t, None, :]).sum(-1))           # [B, D]
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros(x.shape)
    return y.to(x.dtype), h


__all__ = ["FLASH_CHUNK", "flash_attention_bwd_ref", "flash_attention_ref",
           "fused_matmul_rs_ref", "matmul_tiled_ref", "multi_add_ref",
           "paged_attention_ref", "paged_attention_split_ref",
           "selective_scan_ref"]
