"""Wrapper of the hand-written CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``), the port's counterpart of the Pallas
kernel ``repro/kernels/paged_attention.py::paged_attention``.

``paged_attention`` checks its inputs, allocates the output, launches
the kernel on the current CUDA stream and counts the launch in
``paged_attention.launches``.  It takes CUDA tensors only; the plain
version for the CPU is ``repro_torch.kernels.ref.paged_attention_ref``
and ``repro_torch.kernels.ops.paged_attention`` picks between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: what the kernel takes (csrc/paged_attention.cu)
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, i32, i32, i32,
                                        ctypes.c_float, ptr]
        lib.paged_attention.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32, i32, i32, i32]
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib._signatures_set = True
    return lib


def _check(q, k_pages, v_pages, block_tables, lengths) -> None:
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "lengths": lengths}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attention: {name} must be a CUDA "
                             f"tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages and v_pages must share "
                        "one dtype")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and lengths must be "
                        "int32")
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, "
                         f"k_pages {tuple(k_pages.shape)}, v_pages "
                         f"{tuple(v_pages.shape)}")
    b, h, d = q.shape
    _, bs, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"fit pool {tuple(k_pages.shape)}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head dim {d} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"paged_attention: block size {bs} exceeds "
                         f"{MAX_BLOCK_SIZE}")
    if block_tables.ndim != 2 or block_tables.shape[0] != b or \
            lengths.shape != (b,):
        raise ValueError(f"paged_attention: block_tables "
                         f"{tuple(block_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be 16-byte "
                             f"aligned")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """[B, H, D] x pool [N, bs, Hkv, D] block-indexed decode attention on
    the GPU.  ``block_tables``: [B, M] int32 pool indices in logical
    order (every entry below a row's length must be a valid block id);
    ``lengths``: [B] int32 valid tokens per request.  Returns [B, H, D];
    a length-0 row gives zeros."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    b, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _library()
    smem = lib.paged_attention_smem_bytes(q.element_size(), h // hkv, d, bs)
    props = torch.cuda.get_device_properties(q.device)
    limit = getattr(props, "shared_memory_per_block_optin", 48 * 1024)
    if smem > limit:
        raise ValueError(f"paged_attention: needs {smem} bytes of shared "
                         f"memory per block, the device allows {limit} "
                         f"(GQA group {h // hkv}, head dim {d}, block {bs})")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, h, hkv, d, bs, block_tables.shape[1],
        1.0 / d ** 0.5, stream)
    if err:
        raise RuntimeError(f"paged_attention: kernel launch failed with "
                           f"cudaError_t {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


__all__ = ["MAX_BLOCK_SIZE", "MAX_HEAD_DIM", "paged_attention"]
