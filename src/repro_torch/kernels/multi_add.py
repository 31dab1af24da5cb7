"""Wrapper of the hand-written CUDA K-way accumulate (``csrc/multi_add.cu``),
the port's counterpart of the Pallas kernel
``repro/kernels/multi_add.py::multi_add``.

``multi_add`` checks its input, allocates the output, launches the
kernel on the current CUDA stream and counts the launch in
``multi_add.launches``.  It takes CUDA tensors only; the plain version
for the CPU is ``repro_torch.kernels.ref.multi_add_ref`` and
``repro_torch.kernels.ops.multi_add`` picks between the two.

No path of the port calls it, as no path of the reference does (only
``repro/kernels/ops.py`` and the tests): wiring it into the reduce
endpoints would change their results against the reference, whose
reduces add in the input dtype one hop at a time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("multi_add")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.multi_add.argtypes = [i32, ptr, ptr, i32, ctypes.c_longlong,
                                  i32, ptr]
        lib.multi_add.restype = i32
        lib._signatures_set = True
    return lib


def multi_add(stacked: torch.Tensor) -> torch.Tensor:
    """Sum K stacked partials on the GPU: [K, N] -> [N], float32
    accumulation in the order k = 0..K-1, stored in the input dtype
    (float32 or bfloat16)."""
    if stacked.device.type != "cuda":
        raise ValueError(f"multi_add: stacked must be a CUDA tensor, got "
                         f"{stacked.device}")
    if stacked.dtype not in _DTYPES:
        raise TypeError(f"multi_add: dtype {stacked.dtype} not supported "
                        f"(float32, bfloat16)")
    if stacked.ndim != 2 or stacked.shape[0] < 1:
        raise ValueError(f"multi_add: expected [K >= 1, N], got "
                         f"{tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("multi_add: stacked must be contiguous")
    k, n = stacked.shape
    out = stacked.new_empty((n,))
    if n == 0:
        return out
    vec = 16 // stacked.element_size()
    vectorized = (n % vec == 0 and stacked.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    err = _library().multi_add(_DTYPES[stacked.dtype], stacked.data_ptr(),
                               out.data_ptr(), k, n, int(vectorized), stream)
    if err:
        raise RuntimeError(f"multi_add: kernel launch failed with "
                           f"cudaError_t {err}")
    build.count_launch(multi_add)
    return out


multi_add.launches = 0


__all__ = ["multi_add"]
