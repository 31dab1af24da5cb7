"""RG-LRU recurrent block (Griffin / RecurrentGemma), the counterpart of
``repro/models/rglru.py``.

Gated linear recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)
with a_t = exp(-c * softplus(Lambda) * r_t); block-diagonal gate
projections (per head) as in the Griffin paper.  It runs through the
same chunked linear scan as the SSM's plain route
(``models/scan_utils.py``); decode carries [B, lru] plus the conv shift
register, constant in the context length.

The reference has no kernel for this recurrence (no Pallas call), and
neither has the port: it is plain PyTorch on the card too.

Rounding follows the reference: the projections and the causal conv run
in the activation dtype; the gates, ``log_a``, ``beta`` and the state
are float32 (``lam`` is a float32 leaf in a bf16 model); the output is
cast back to x's dtype before the output projection.  ``jax.nn.gelu``
is the tanh approximation by default, and so is the port's.

On a rank's tree (a bound model axis) the block runs on the rank's lru /
m channels: ``w_x`` and ``w_y`` column-parallel, ``w_a`` / ``w_i`` its
diagonal blocks, ``lam`` and ``conv_w`` its channels, ``out``
row-parallel and reduced over "model".
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import copy_to_model, reduce_from_model
from repro_torch.models.scan_utils import chunked_linear_scan
from repro_torch.models.ssm import _causal_conv

_C = 8.0


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # [B, K-1, lru]
    h: torch.Tensor      # [B, lru] float32


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B, S, lru] -> per-head block-diagonal projection.
    w: [heads, bh, bh] with heads * bh == lru."""
    heads, bh, _ = w.shape
    b, s, lru = x.shape
    xh = x.reshape(b, s, heads, bh)
    return torch.einsum("bshi,hij->bshj", xh, w).reshape(b, s, lru)


def rglru_block(x: torch.Tensor, p: dict, *, chunk: int = 128,
                state: Optional[RGLRUState] = None,
                single_step: bool = False
                ) -> Tuple[torch.Tensor, RGLRUState]:
    """x: [B, S, D].  Params: w_x [D, lru], w_y [D, lru], conv_w [K, lru],
    w_a [heads, bh, bh], w_i [heads, bh, bh], lam [lru] (float32),
    out [lru, D].  Returns (y [B, S, D], new state)."""
    b = x.shape[0]
    lru = p["lam"].shape[0]

    x = copy_to_model(x)
    xb = x @ p["w_x"]                                   # [B, S, lru]
    yb = x @ p["w_y"]
    conv_prefix = state.conv if state is not None else None
    xb, new_conv = _causal_conv(xb, p["conv_w"], conv_prefix)

    r = torch.sigmoid(_block_diag(xb, p["w_a"]).float())
    i = torch.sigmoid(_block_diag(xb, p["w_i"]).float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)                                # [B, S, lru]
    gated = i * xb.float()
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    bb = beta * gated

    h0 = (state.h if state is not None
          else torch.zeros((b, lru), dtype=torch.float32, device=x.device))
    if single_step:
        assert x.shape[1] == 1
        h_new = a[:, 0] * h0 + bb[:, 0]
        h_all = h_new[:, None]
    else:
        h_all, h_new = chunked_linear_scan(a, bb, h0, chunk=chunk)

    out = (h_all * F.gelu(yb.float(), approximate="tanh")).to(x.dtype)
    return reduce_from_model(out @ p["out"]), RGLRUState(conv=new_conv,
                                                         h=h_new)


def init_rglru_params(gen: Optional[torch.Generator], d_model: int,
                      lru: int, heads: int, d_conv: int,
                      dtype: torch.dtype,
                      device: Optional[torch.device] = None) -> dict:
    """Random block weights from ``gen`` (on its device) with the
    reference's shapes and scales (float32 normals scaled, then cast);
    ``lam`` is float32, evenly spaced over [0.5, 3].  ``gen=None`` with
    the meta ``device`` gives the shapes only."""
    dev = gen.device if gen is not None else device
    bh = lru // heads

    def normal(shape, scale):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    scale = d_model ** -0.5
    return {
        "w_x": normal((d_model, lru), scale),
        "w_y": normal((d_model, lru), scale),
        "conv_w": normal((d_conv, lru), 0.1),
        "w_a": normal((heads, bh, bh), bh ** -0.5),
        "w_i": normal((heads, bh, bh), bh ** -0.5),
        "lam": torch.linspace(0.5, 3.0, lru, dtype=torch.float32,
                              device=dev),
        "out": normal((lru, d_model), lru ** -0.5),
    }


__all__ = ["RGLRUState", "init_rglru_params", "rglru_block"]
