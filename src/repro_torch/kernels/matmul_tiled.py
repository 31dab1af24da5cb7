"""The hand-written tiled GEMM (``csrc/matmul_tiled.cu``): the port of
``repro/kernels/fused_matmul_rs.py::matmul_tiled``, the block GEMM of the
fused matmul + ring reduce-scatter (the ring itself is
``repro_torch.collectives.shardmap_impl.fused_matmul_rs``).

* ``matmul_tiled_cuda`` launches the kernel: ``.launches`` counts every
  launch, ``.variant_launches`` each variant's (``matmul_variant`` picks
  one from the dtype, shapes and alignment; the C entry point takes it
  explicitly);
* ``MatmulTiledFn`` makes it differentiable: the kernel forward with the
  reference's dense backward (float32 products, ``torch.matmul`` with
  TF32 off).  ``ops.matmul_tiled`` picks it for a CUDA tensor and the
  plain version (``ref.matmul_tiled_ref``) for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the C entry point's variant codes: the float32 SIMT kernel, the WMMA
#: kernel with masked loads (bf16, any shape), the TMA + wgmma kernel
VARIANTS = {"simt_f32": 0, "wmma_masked": 1, "wgmma": 2}


def _library() -> ctypes.CDLL:
    lib = build.load("matmul_tiled")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.matmul_tiled.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32,
                                     ptr]
        lib.matmul_tiled.restype = i32
        lib._signatures_set = True
    return lib


def matmul_variant(dtype: torch.dtype, k: int, n: int, x_ptr: int = 0,
                   w_ptr: int = 0) -> str:
    """The variant a call takes: ``wgmma`` for bfloat16 with K and N
    multiples of 8 and 16-byte aligned x and w (every row and stride a
    multiple of 16 bytes, as TMA needs), ``wmma_masked`` for other
    bfloat16 calls, ``simt_f32`` for float32."""
    if dtype == torch.float32:
        return "simt_f32"
    if k % 8 == 0 and n % 8 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0:
        return "wgmma"
    return "wmma_masked"


def matmul_tiled_cuda(x: torch.Tensor, w: torch.Tensor,
                      variant: Optional[str] = None) -> torch.Tensor:
    """``[M, K] @ [K, N] -> [M, N]`` on the GPU through the hand-written
    kernel: float32 accumulation, the output in the inputs' dtype
    (float32 on the SIMT units, bfloat16 on the tensor cores).

    ``variant`` None takes ``matmul_variant``'s pick; naming one forces it
    where it can take the call (``wmma_masked`` on a call the wgmma
    variant takes times the earlier kernel beside the new one) and raises
    otherwise."""
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"matmul_tiled: {name} must be a CUDA tensor "
                             f"on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"matmul_tiled: {name} must be contiguous")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"matmul_tiled: x and w must share one dtype of "
                        f"float32, bfloat16; got {x.dtype}, {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_tiled: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not multiply")
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"matmul_tiled: dims {(m, k, n)} exceed int32")
    chosen = matmul_variant(x.dtype, k, n, x.data_ptr(), w.data_ptr())
    variant = chosen if variant is None else variant
    if variant != chosen and (variant, chosen) != ("wmma_masked", "wgmma"):
        raise ValueError(f"matmul_tiled: variant {variant!r} cannot take "
                         f"{x.dtype} [{m}, {k}] @ [{k}, {n}] at these "
                         f"alignments (it takes {chosen!r})")
    out = x.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().matmul_tiled(_DTYPES[x.dtype], x.data_ptr(),
                                  w.data_ptr(), out.data_ptr(), m, n, k,
                                  VARIANTS[variant], stream)
    build.check_launch("matmul_tiled", err)
    build.count_launch(matmul_tiled_cuda, variant)
    return out


matmul_tiled_cuda.launches = 0
matmul_tiled_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


@torch.library.custom_op("repro_torch::matmul_tiled_meta", mutates_args=())
def matmul_tiled_meta(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's shape-only body on meta tensors: the ``[M, N]``
    output, nothing launched or counted (``launch.dryrun``)."""
    raise ValueError("matmul_tiled_meta takes meta tensors only")


@matmul_tiled_meta.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], w.shape[1]))


class MatmulTiledFn(torch.autograd.Function):
    """The kernel forward with the reference's dense backward
    (``repro/kernels/fused_matmul_rs.py::_mm_bwd``): the products in
    float32, each gradient cast to its input's dtype.  On meta tensors
    the forward is :func:`matmul_tiled_meta`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_meta:
            return matmul_tiled_meta(x, w)
        return matmul_tiled_cuda(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        dx = torch.matmul(gf, w.float().t()).to(x.dtype)
        dw = torch.matmul(x.float().t(), gf).to(w.dtype)
        return dx, dw


__all__ = ["MatmulTiledFn", "VARIANTS", "matmul_tiled_cuda",
           "matmul_tiled_meta", "matmul_variant"]
