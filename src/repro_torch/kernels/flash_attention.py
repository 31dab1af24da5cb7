"""The hand-written flash-attention kernel (``csrc/flash_attention.cu``):
the port of ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``).

* ``flash_attention_cuda`` launches the kernel:
  ``[B, H, S, D] x [B, Hkv, S, D] -> (o [B, H, S, D], lse [B, H, S])``;
  ``.launches`` counts every launch, ``.variant_launches`` each
  variant's (``flash_variant`` picks one from the dtype and head dim; the
  C entry point takes it explicitly);
* ``FlashAttentionFn`` makes it differentiable: the kernel forward, and
  the plain flash backward (``ref.flash_attention_bwd_ref``) from the
  saved output and row log-sum-exp.  The reference has no backward kernel
  for this row: JAX differentiates its chunked jnp attention, and so the
  port's backward is plain PyTorch.  ``ops.flash_attention`` picks it for
  a CUDA tensor and the plain version (``ref.flash_attention_ref``) for a
  CPU tensor.

The kernel takes float32 (SIMT FMAs) or bfloat16 (tensor cores: wgmma
with TMA loads at D 64 and 128, mma.sync at D 16, 32, 96 and 160)
inputs, D in ``HEAD_DIMS``, S a multiple of 64, and any batch, head and
row strides as long as the last dimension is contiguous; bfloat16 rows must
be 16-byte aligned.  The output takes q's strides, so that attention
called on ``[B, S, H, D]`` tensors seen as ``[B, H, S, D]`` needs no
copy on the way in or out.  Anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_bwd_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 96, 128, 160)
#: the C entry point's variant codes: the float32 SIMT kernel, the
#: mma.sync kernel (bf16, any head dim), the TMA + wgmma kernel
VARIANTS = {"simt_f32": 0, "mma_sync": 1, "wgmma": 2}


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = ([i32, i32, i32] + [ptr] * 5
                                            + [i32] * 4 + [i64] * 12
                                            + [i32] * 3 + [ctypes.c_float,
                                                           ptr])
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_tile.argtypes = []
        lib.flash_attention_tile.restype = i32
        lib._signatures_set = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    name = "flash_attention"
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {key} must be a CUDA tensor on "
                             f"{q.device}, got {t.device}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: {key} must be [B, H, S, D] with a "
                             f"contiguous last dimension, got "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v must share one dtype of float32, "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape != (b, hkv, s, d) or v.shape != k.shape or hkv < 1
            or h % hkv):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need k, v [B, Hkv, S, D] "
                         f"with H a multiple of Hkv")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    tile = _library().flash_attention_tile()
    if s < 1 or s % tile:
        raise ValueError(f"{name}: sequence {s} must be a positive multiple "
                         f"of the kernel's tile {tile}")
    if b * h >= 2 ** 16 or s >= 2 ** 30:
        raise ValueError(f"{name}: B * H = {b * h} or S = {s} too large")
    if window is not None and abs(window) >= 2 ** 30:
        raise ValueError(f"{name}: window {window} out of range")
    if q.dtype == torch.bfloat16:
        for key, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"{name}: bfloat16 {key} needs 16-byte "
                                 f"aligned rows (strides {t.stride()})")


def flash_variant(dtype: torch.dtype, d: int) -> str:
    """The variant a call takes: ``wgmma`` for bfloat16 at head dim 64 or
    128, ``mma_sync`` for other bfloat16 head dims, ``simt_f32`` for
    float32."""
    if dtype == torch.float32:
        return "simt_f32"
    return "wgmma" if d in (64, 128) else "mma_sync"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         variant: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention on the GPU through the hand-written kernel: (o in q's
    dtype and strides, lse [B, H, S] float32).  ``variant`` None takes
    ``flash_variant``'s pick; naming one forces it where it can take the
    call (``mma_sync`` on a call the wgmma variant takes times the earlier
    kernel beside the new one) and raises otherwise."""
    _check(q, k, v, window)
    b, h, s, d = q.shape
    chosen = flash_variant(q.dtype, d)
    variant = chosen if variant is None else variant
    if variant != chosen and (variant, chosen) != ("mma_sync", "wgmma"):
        raise ValueError(f"flash_attention: variant {variant!r} cannot take "
                         f"{q.dtype} at head dim {d} (it takes {chosen!r})")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        _DTYPES[q.dtype], VARIANTS[variant], d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, k.shape[1], s,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window is not None),
        0 if window is None else int(window), 1.0 / (d ** 0.5), stream)
    build.check_launch("flash_attention", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[variant] += 1
    return o, lse


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel forward, saving q, k, v, o and lse; the backward is the
    plain flash backward (``ref.flash_attention_bwd_ref``), each gradient
    cast to its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = flash_attention_cuda(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                             ctx.causal, ctx.window)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


__all__ = ["FlashAttentionFn", "HEAD_DIMS", "VARIANTS", "flash_attention_cuda",
           "flash_variant"]
