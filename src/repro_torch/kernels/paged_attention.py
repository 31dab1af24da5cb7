"""Wrapper of the hand-written CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``), the port's counterpart of the Pallas
kernel ``repro/kernels/paged_attention.py::paged_attention``.

``paged_attention`` checks its inputs, picks the split of every request's
context (``plan_splits``: host integers only, never ``lengths``),
allocates the output and the splits' float32 scratch, launches the
kernel once on the current CUDA stream and counts the launch in
``paged_attention.launches``.  It takes CUDA tensors only; the plain
version for the CPU is ``repro_torch.kernels.ref.paged_attention_ref``
(``paged_attention_split_ref`` repeats the kernel's splits) and
``repro_torch.kernels.ops.paged_attention`` picks between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: what the kernel takes (csrc/paged_attention.cu)
MAX_HEAD_DIM = 256
MAX_BLOCK_SIZE = 64
#: csrc/paged_attention.cu's kMaxSplits and kMaxSplitBlocks
MAX_SPLITS = 128
MAX_SPLIT_BLOCKS = 4096
#: a split covers at least MIN_SPLIT_TOKENS (its fixed cost: the table
#: slice, the ring's fill, one partial) and at most MAX_SPLIT_TOKENS (so a
#: long request spreads over SMs) of a full-length row
MIN_SPLIT_TOKENS = 64
MAX_SPLIT_TOKENS = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: launch counters of the split merge, by (device index, stream): zero
#: between calls (the kernel's last split of a row zeroes its own)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                        ptr, ptr, ptr, i32, i32, i32, i32,
                                        i32, i32, i32, i32, ctypes.c_float,
                                        ptr]
        lib.paged_attention.restype = i32
        lib.paged_attention_smem_bytes.argtypes = [i32] * 5
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_describe.argtypes = [i32] * 5 + [ptr]
        lib.paged_attention_describe.restype = i32
        lib._signatures_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _device(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of a CUDA device."""
    props = torch.cuda.get_device_properties(index)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", 48 * 1024))


def plan_splits(m: int, bs: int, b: int, hkv: int, slots: int
                ) -> Tuple[int, int]:
    """(blocks a split, splits) for block tables of ``m`` blocks of ``bs``
    tokens, ``b`` requests and ``hkv`` KV heads on a card that holds
    ``slots`` blocks of the kernel at once.  Full rows then fill about one
    wave, a split spans at most ``MAX_SPLIT_TOKENS`` and at least
    ``MIN_SPLIT_TOKENS``.  Only these integers decide it, so one server
    plans every decode step alike and the host never waits for the
    card's ``lengths``.  Split ``s`` covers logical blocks ``[s * blocks,
    min(m, (s + 1) * blocks))``."""
    want = max(-(-slots // (b * hkv)), -(-m * bs // MAX_SPLIT_TOKENS), 1)
    blocks = -(-m // min(want, MAX_SPLITS))
    blocks = min(max(blocks, -(-MIN_SPLIT_TOKENS // bs)), m)
    return blocks, -(-m // blocks)


def split_plan(q: torch.Tensor, k_pages: torch.Tensor,
               block_tables: torch.Tensor, slots: int) -> Tuple[int, int]:
    """``plan_splits`` from the shapes of a call's tensors (no data)."""
    return plan_splits(block_tables.shape[1], k_pages.shape[1], q.shape[0],
                       k_pages.shape[2], slots)


def _describe(dtype: torch.dtype, group: int, d: int, split_blocks: int,
              n_split: int) -> dict:
    out = (ctypes.c_int * 8)()
    err = _library().paged_attention_describe(
        _DTYPES[dtype], group, d, split_blocks, n_split,
        ctypes.addressof(out))
    build.check_launch("paged_attention_describe", err)
    info = dict(zip(("registers", "spill_bytes", "threads", "smem_bytes",
                     "blocks_per_sm", "query_rows", "stage_tokens"), out))
    info["kernel"] = "paged_mma" if out[7] else "paged_simt"
    return info


@functools.lru_cache(maxsize=None)
def slots(index: int, dtype: torch.dtype, group: int, d: int) -> int:
    """Blocks of the kernel for (dtype, GQA group, head dim) that CUDA
    device ``index`` holds at once: its SMs x the blocks resident an SM
    (the occupancy API, at a one-block table slice)."""
    return (_device(index)[0]
            * _describe(dtype, group, d, 1, 1)["blocks_per_sm"])


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


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    cnt = _COUNTERS.get(key)
    if cnt is None or cnt.numel() < n:
        cnt = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return cnt


def _smem(lib, dtype, group, d, split_blocks, n_split, device) -> int:
    smem = lib.paged_attention_smem_bytes(_DTYPES[dtype], group, d,
                                          split_blocks, n_split)
    limit = _device(device.index)[1]
    if not 0 <= smem <= limit:
        raise ValueError(f"paged_attention: needs {smem} bytes of shared "
                         f"memory per block, the device allows {limit} "
                         f"(GQA group {group}, head dim {d}, "
                         f"{split_blocks} blocks a split)")
    return smem


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """[B, H, D] x pool [N, bs, Hkv, D] block-indexed decode attention on
    the GPU.  ``block_tables``: [B, M] int32 pool indices in logical
    order (every entry below a row's length must be a valid block id);
    ``lengths``: [B] int32 valid tokens per request.  Returns [B, H, D];
    a length-0 row gives zeros, and so do all rows when ``M`` is 0 (no
    launch then, as for ``B`` 0).  One kernel launch; two calls on the
    same inputs give bitwise equal outputs."""
    _check(q, k_pages, v_pages, block_tables, lengths)
    b, h, d = q.shape
    _, bs, hkv, _ = k_pages.shape
    if b == 0 or block_tables.shape[1] == 0:
        return torch.zeros_like(q)   # no request, or no token to attend to
    lib = _library()
    split_blocks, n_split = split_plan(
        q, k_pages, block_tables,
        slots(q.device.index, q.dtype, h // hkv, d))
    if split_blocks > MAX_SPLIT_BLOCKS:
        raise ValueError(f"paged_attention: {block_tables.shape[1]} blocks "
                         f"a row need {split_blocks} blocks a split, more "
                         f"than {MAX_SPLIT_BLOCKS}")
    _smem(lib, q.dtype, h // hkv, d, split_blocks, n_split, q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if n_split > 1:
        part_acc = torch.empty((b, h, n_split, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, h, n_split, 2), dtype=torch.float32,
                              device=q.device)
        counters = _counters(q.device, stream, b * h)
        scratch = (part_acc.data_ptr(), part_ml.data_ptr(),
                   counters.data_ptr())
    else:
        scratch = (None, None, None)
    err = lib.paged_attention(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), *scratch, b, h, hkv, d, bs, block_tables.shape[1],
        split_blocks, n_split, 1.0 / d ** 0.5, stream)
    build.check_launch("paged_attention", err)
    build.count_launch(paged_attention)
    return out


def describe(q: torch.Tensor, k_pages: torch.Tensor,
             block_tables: torch.Tensor) -> dict:
    """How a call on these tensors runs on the current card: the split
    plan, the kernel (``paged_simt`` or ``paged_mma``), registers and
    spilled bytes a thread (from the compiled kernel), threads, dynamic
    shared memory, query heads and tokens a stage of a block, blocks
    resident per SM (the occupancy API), the blocks a (request, KV head)
    pair takes per split (``query_chunks``) and the grid's blocks."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    group = h // hkv
    split_blocks, n_split = split_plan(
        q, k_pages, block_tables, slots(q.device.index, q.dtype, group, d))
    info = _describe(q.dtype, group, d, split_blocks, n_split)
    qchunks = -(-group // info["query_rows"])
    info.update(split_blocks=split_blocks, n_split=n_split,
                query_chunks=qchunks, sms=_device(q.device.index)[0],
                grid_blocks=n_split * hkv * qchunks * b)
    return info


paged_attention.launches = 0


@torch.library.custom_op("repro_torch::paged_attention_meta",
                         mutates_args=())
def paged_attention_meta(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_tables: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's shape-only body on meta tensors: the [B, H, D]
    output, nothing launched or counted (``launch.dryrun``).  The splits'
    float32 scratch is left out: its size follows the card's occupancy
    (``plan_splits``), which a meta tensor has no card to ask."""
    raise ValueError("paged_attention_meta takes meta tensors only")


@paged_attention_meta.register_fake
def _(q, k_pages, v_pages, block_tables, lengths):
    return torch.empty_like(q)


__all__ = ["MAX_BLOCK_SIZE", "MAX_HEAD_DIM", "MAX_SPLITS",
           "MAX_SPLIT_BLOCKS", "describe", "paged_attention",
           "paged_attention_meta", "plan_splits",
           "slots", "split_plan"]
