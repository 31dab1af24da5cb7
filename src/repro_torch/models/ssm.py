"""Mamba-1 (selective SSM) blocks (counterpart of ``repro/models/ssm.py``).

The scan has two routes, as in the reference: the chunked linear scan
(``models/scan_utils.py``), which materialises the [B, S, d_inner, N]
state expansion, and, with ``use_kernel``, the fused selective scan
(``kernels/ops.py::selective_scan``), which keeps it out of device
memory: the hand-written CUDA kernels on a CUDA tensor, the plain
sequential recurrence on the CPU.  Decode carries a constant-size
(conv window, SSM state) pair and runs the single-step arithmetic.

Rounding follows the reference: projections, the causal conv and SiLU
run in the activation dtype; ``delta`` is computed in the activation
dtype and then cast to float32; the scan, the skip term and the gate run
in float32 and the result is cast back before the output projection.

On a rank's tree (a bound model axis, ``layers.model_parallel``) the
block runs on the rank's di / m channels: ``in_proj`` holds its channels
of x and of z, ``conv_w``, ``dt_w``, ``dt_b``, ``a_log`` and ``d_skip``
its channels; ``x_proj`` is row-parallel, its partial ``[B, S, R + 2N]``
reduced over "model" before the split (and its cotangent, a partial sum
on each rank, reduced in the backward); ``out_proj`` is row-parallel.
The scan runs at the local width.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import copy_to_model, reduce_from_model
from repro_torch.models.scan_utils import chunked_linear_scan


class SSMState(NamedTuple):
    conv: torch.Tensor   # [B, d_conv - 1, d_inner]  (shift register)
    h: torch.Tensor      # [B, d_inner, N]


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prefix: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along seq as a shifted sum (not ``conv1d``:
    cuDNN would run a float32 convolution in TF32).  x: [B, S, C];
    w: [K, C]; prefix: [B, K-1, C] or None (zeros).  Returns (out,
    new_prefix)."""
    k = w.shape[0]
    if prefix is None:
        prefix = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prefix, x], dim=1)
    s = x.shape[1]
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xp[:, j:j + s] * w[j]
    return out, xp[:, s:]


def mamba_block(x: torch.Tensor, p: dict, *, ssm_state: int,
                chunk: int = 128, state: Optional[SSMState] = None,
                single_step: bool = False, use_kernel: bool = False
                ) -> Tuple[torch.Tensor, SSMState]:
    """One Mamba-1 mixing block.

    x: [B, S, D].  Params ``p``: in_proj [D, 2*di], conv_w [K, di],
    x_proj [di, R+2N], dt_w [R, di], dt_b [di], a_log [di, N] (float32),
    d_skip [di] (float32), out_proj [di, D].  Returns (y [B, S, D],
    new_state).  With ``use_kernel`` the scan takes the fused kernel: the
    trainable pair when autograd needs a gradient through it, the
    forward-only kernel otherwise.
    """
    b, s, _ = x.shape
    di = p["a_log"].shape[0]
    n = ssm_state
    r = p["dt_w"].shape[0]

    xs, z = (copy_to_model(x) @ p["in_proj"]).chunk(2, dim=-1)  # [B,S,di]
    conv_prefix = state.conv if state is not None else None
    xs, new_conv = _causal_conv(xs, p["conv_w"], conv_prefix)
    xs = F.silu(xs)

    # [B, S, R+2N], whole on every rank of a model axis
    dbc = copy_to_model(reduce_from_model(xs @ p["x_proj"]))
    dt, b_ssm, c_ssm = torch.split(dbc, [r, n, n], dim=-1)
    delta = F.softplus(dt @ p["dt_w"] + p["dt_b"])        # [B, S, di]
    a = -torch.exp(p["a_log"].float())                    # [di, N]

    delta32 = delta.float()
    xs32 = xs.float()
    b32 = b_ssm.float()
    c32 = c_ssm.float()
    h0 = (state.h if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32,
                           device=x.device))
    if single_step:
        assert s == 1
        a_bar = torch.exp(delta32[:, 0, :, None] * a)         # [B, di, N]
        b_bar = delta32[:, 0, :, None] * b32[:, 0, None, :] \
            * xs32[:, 0, :, None]
        h_new = a_bar * h0 + b_bar
        y = (h_new * c32[:, 0, None, :]).sum(-1)[:, None]    # [B, 1, di]
    elif use_kernel:
        trainable = torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta32, xs32, b32, c32, a, h0))
        y, h_new = ops.selective_scan(
            delta32.contiguous(), xs32.contiguous(), b32.contiguous(),
            c32.contiguous(), a.contiguous(), h0.contiguous(),
            trainable=trainable)
    else:
        # discretize: a_bar = exp(delta * A); b_bar = delta * B * x
        a_bar = torch.exp(delta32[..., None] * a)             # [B,S,di,N]
        b_bar = delta32[..., None] * b32[..., None, :] * xs32[..., None]
        h_all, h_new = chunked_linear_scan(a_bar, b_bar, h0, chunk=chunk)
        y = torch.einsum("bsdn,bsn->bsd", h_all, c32)          # [B, S, di]
    y = y + xs32 * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return (reduce_from_model(y @ p["out_proj"]),
            SSMState(conv=new_conv, h=h_new))


def init_mamba_params(gen: Optional[torch.Generator], d_model: int,
                      d_inner: int, ssm_state: int, dt_rank: int,
                      d_conv: int, dtype: torch.dtype,
                      device: Optional[torch.device] = None) -> dict:
    """Random block weights from ``gen`` (on its device), with the
    reference's shapes, scales and constants (float32 normals scaled,
    then cast).  ``a_log`` and ``d_skip`` stay float32.  ``gen=None``
    with the meta ``device`` gives the shapes only."""
    dev = gen.device if gen is not None else device

    def normal(shape, scale):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=dev)
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    a_log = torch.log(torch.arange(1, ssm_state + 1, dtype=torch.float32,
                                   device=dev)).expand(d_inner, ssm_state)
    return {
        "in_proj": normal((d_model, 2 * d_inner), d_model ** -0.5),
        "conv_w": normal((d_conv, d_inner), 0.1),
        "x_proj": normal((d_inner, dt_rank + 2 * ssm_state),
                         d_inner ** -0.5),
        "dt_w": normal((dt_rank, d_inner), dt_rank ** -0.5),
        "dt_b": torch.full((d_inner,), -4.6, dtype=dtype, device=dev),
        "a_log": a_log.contiguous(),
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": normal((d_inner, d_model), d_inner ** -0.5),
    }


__all__ = ["SSMState", "init_mamba_params", "mamba_block"]
