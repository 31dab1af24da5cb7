"""The hand-written tiled GEMM (``csrc/matmul_tiled.cu``): the port of
``repro/kernels/fused_matmul_rs.py::matmul_tiled``, the block GEMM of the
fused matmul + ring reduce-scatter (the ring itself is
``repro_torch.collectives.shardmap_impl.fused_matmul_rs``).

* ``matmul_tiled_cuda`` launches the kernel (``.launches`` counts);
* ``MatmulTiledFn`` makes it differentiable: the kernel forward with the
  reference's dense backward (float32 products, ``torch.matmul`` with
  TF32 off).  ``ops.matmul_tiled`` picks it for a CUDA tensor and the
  plain version (``ref.matmul_tiled_ref``) for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("matmul_tiled")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.matmul_tiled.argtypes = [i32, ptr, ptr, ptr, i32, i32, i32, i32,
                                     ptr]
        lib.matmul_tiled.restype = i32
        lib._signatures_set = True
    return lib


def matmul_tiled_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[M, K] @ [K, N] -> [M, N]`` on the GPU through the hand-written
    kernel: float32 accumulation, the output in the inputs' dtype
    (float32 on the SIMT units, bfloat16 on the tensor cores)."""
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
    out = x.new_empty((m, n))
    if m == 0 or n == 0:
        return out
    vectorized = (x.dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0
                  and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().matmul_tiled(_DTYPES[x.dtype], x.data_ptr(),
                                  w.data_ptr(), out.data_ptr(), m, n, k,
                                  int(vectorized), stream)
    if err:
        raise RuntimeError(f"matmul_tiled: kernel launch failed with "
                           f"cudaError_t {err}")
    matmul_tiled_cuda.launches += 1
    return out


matmul_tiled_cuda.launches = 0


class MatmulTiledFn(torch.autograd.Function):
    """The kernel forward with the reference's dense backward
    (``repro/kernels/fused_matmul_rs.py::_mm_bwd``): the products in
    float32, each gradient cast to its input's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return matmul_tiled_cuda(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.float()
        dx = torch.matmul(gf, w.float().t()).to(x.dtype)
        dw = torch.matmul(x.float().t(), gf).to(w.dtype)
        return dx, dw


__all__ = ["MatmulTiledFn", "matmul_tiled_cuda"]
