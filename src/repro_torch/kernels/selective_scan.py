"""Wrappers of the hand-written CUDA selective-scan kernels
(``csrc/selective_scan.cu``), the port's counterparts of the Pallas
kernels in ``repro/kernels/selective_scan.py``:

* ``selective_scan`` -- the forward (``_scan_kernel``);
* ``selective_scan_fwd_ckpt`` -- the same forward, also writing the state
  entering every chunk (``_scan_fwd_ckpt_kernel``);
* ``selective_scan_bwd`` -- the reverse adjoint from those checkpoints
  (``_scan_bwd_kernel``);
* ``selective_scan_trainable`` -- the last two as one
  ``torch.autograd.Function``.

Each wrapper checks its inputs and raises on what its kernel does not
take, allocates outputs and scratch with ``torch.empty``, launches on the
current CUDA stream, raises if the launch failed, and counts the launch
in ``<wrapper>.launches``.  They take CUDA tensors only; the plain
version for the CPU is ``repro_torch.kernels.ref.selective_scan_ref`` and
``repro_torch.kernels.ops.selective_scan`` picks between the two.

Shapes: dt/x [B, S, D]; b/c [B, S, N]; a [D, N]; h0 [B, D, N], with N a
power of two up to 16 and any S and D.  The forward takes float32 or
bfloat16 dt, x, b, c (one type; y comes back in it) and float32 a and h0;
the backward and the trainable entry point take float32 only, as the
training path passes (``repro/models/ssm.py:96-98``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_F32 = (torch.float32,)


def _library() -> ctypes.CDLL:
    lib = build.load("selective_scan")
    if not getattr(lib, "_signatures_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_fwd.argtypes = [i32, i32] + [ptr] * 9 + \
            [i32] * 4 + [ptr]
        lib.selective_scan_fwd.restype = i32
        lib.selective_scan_bwd.argtypes = [ptr] * 14 + [i32] * 4 + [ptr]
        lib.selective_scan_bwd.restype = i32
        lib.selective_scan_chunk.argtypes = []
        lib.selective_scan_chunk.restype = i32
        lib.selective_scan_channels.argtypes = []
        lib.selective_scan_channels.restype = i32
        lib.selective_scan_describe.argtypes = [i32, i32, i32, ptr]
        lib.selective_scan_describe.restype = i32
        lib._signatures_set = True
    return lib


def _check(name: str, dt, x, b, c, a, h0, dtypes) -> Tuple[int, int, int,
                                                           int]:
    tensors = {"dt": dt, "x": x, "b": b, "c": c, "a": a, "h0": h0}
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {key} must be a CUDA tensor on "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if x.dtype not in dtypes or any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError(f"{name}: dt, x, b, c must share one dtype of "
                        f"{[str(d) for d in dtypes]}, got {dt.dtype}, "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if a.dtype != torch.float32 or h0.dtype != torch.float32:
        raise TypeError(f"{name}: a and h0 must be float32, got {a.dtype}, "
                        f"{h0.dtype}")
    if x.ndim != 3 or dt.shape != x.shape or a.ndim != 2:
        raise ValueError(f"{name}: shapes dt {tuple(dt.shape)}, x "
                         f"{tuple(x.shape)}, a {tuple(a.shape)}")
    bsz, s, d = x.shape
    n = a.shape[1]
    if (a.shape[0] != d or b.shape != (bsz, s, n) or c.shape != (bsz, s, n)
            or h0.shape != (bsz, d, n)):
        raise ValueError(f"{name}: b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"a {tuple(a.shape)}, h0 {tuple(h0.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if n < 1 or n > MAX_STATE or n & (n - 1):
        raise ValueError(f"{name}: state size {n} must be a power of two "
                         f"up to {MAX_STATE}")
    if min(bsz, s, d) < 1:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    return bsz, s, d, n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{err}")


def _forward(name, dt, x, b, c, a, h0, ckpt: bool):
    bsz, s, d, n = _check(name, dt, x, b, c, a, h0, tuple(_DTYPES))
    lib = _library()
    k = -(-s // lib.selective_scan_chunk())
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    hck = (torch.empty((bsz, k, d, n), dtype=torch.float32, device=x.device)
           if ckpt else None)
    err = lib.selective_scan_fwd(
        _DTYPES[x.dtype], int(ckpt), dt.data_ptr(), x.data_ptr(),
        b.data_ptr(), c.data_ptr(), a.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(),
        hck.data_ptr() if ckpt else None, bsz, s, d, n, _stream(x))
    _raise_on(name, err)
    return y, h_final, hck


def selective_scan(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward scan on the GPU: (y [B, S, D] in x.dtype, h_final
    [B, D, N] float32)."""
    y, h_final, _ = _forward("selective_scan", dt, x, b, c, a, h0, False)
    selective_scan.launches += 1
    return y, h_final


def selective_scan_fwd_ckpt(dt: torch.Tensor, x: torch.Tensor,
                            b: torch.Tensor, c: torch.Tensor,
                            a: torch.Tensor, h0: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Forward scan that also returns hck [B, ceil(S / chunk), D, N]
    float32, the state entering every chunk: what the backward kernel
    recomputes from."""
    out = _forward("selective_scan_fwd_ckpt", dt, x, b, c, a, h0, True)
    selective_scan_fwd_ckpt.launches += 1
    return out


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, a: torch.Tensor, hck: torch.Tensor,
                       dy: torch.Tensor, dh_final: torch.Tensor):
    """Gradients of the scan from the forward's checkpoints, all float32:
    (ddt, dx [B, S, D], db, dc [B, S, N], da [D, N], dh0 [B, D, N]).  The
    kernel writes per-block partials of db/dc (summed over channels) and
    per-batch dA; they are summed here."""
    name = "selective_scan_bwd"
    bsz, s, d, n = _check(name, dt, x, b, c, a, dh_final, _F32)
    lib = _library()
    k = -(-s // lib.selective_scan_chunk())
    groups = -(-d // lib.selective_scan_channels())
    for key, t, shape in (("hck", hck, (bsz, k, d, n)),
                          ("dy", dy, (bsz, s, d))):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.shape != shape):
            raise ValueError(f"{name}: {key} must be a contiguous float32 "
                             f"{shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ddt = torch.empty_like(x)
    dx = torch.empty_like(x)
    db_part = torch.empty((bsz, groups, s, n), dtype=torch.float32,
                          device=x.device)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty_like(dh_final)
    dh0 = torch.empty_like(dh_final)
    err = lib.selective_scan_bwd(
        dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
        a.data_ptr(), hck.data_ptr(), dy.data_ptr(), dh_final.data_ptr(),
        ddt.data_ptr(), dx.data_ptr(), db_part.data_ptr(),
        dc_part.data_ptr(), da_part.data_ptr(), dh0.data_ptr(), bsz, s, d,
        n, _stream(x))
    _raise_on(name, err)
    selective_scan_bwd.launches += 1
    return (ddt, dx, db_part.sum(dim=1), dc_part.sum(dim=1),
            da_part.sum(dim=0), dh0)


def describe(kind: str, dtype: torch.dtype, n: int) -> dict:
    """How one scan kernel runs on the current card: ``kind`` is
    ``"fwd"``, ``"ckpt"`` or ``"bwd"`` (float32).  Registers and spilled
    bytes a thread (from the compiled kernel), threads, dynamic shared
    memory and channels a block, and blocks resident per SM (the occupancy
    API)."""
    out = (ctypes.c_int * 6)()
    kinds = {"fwd": 0, "ckpt": 1, "bwd": 2}
    err = _library().selective_scan_describe(kinds[kind], _DTYPES[dtype], n,
                                             ctypes.addressof(out))
    _raise_on("selective_scan_describe", err)
    return dict(zip(("registers", "spill_bytes", "threads", "smem_bytes",
                     "blocks_per_sm", "channels"), out))


selective_scan.launches = 0
selective_scan_fwd_ckpt.launches = 0
selective_scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """Differentiable scan: the forward saves only the chunk-start states
    (``selective_scan_fwd_ckpt``); the backward recomputes within chunks
    (``selective_scan_bwd``)."""

    @staticmethod
    def forward(ctx, dt, x, b, c, a, h0):
        y, h_final, hck = selective_scan_fwd_ckpt(dt, x, b, c, a, h0)
        ctx.save_for_backward(dt, x, b, c, a, hck)
        return y, h_final

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor],
                 dh_final: Optional[torch.Tensor]):
        dt, x, b, c, a, hck = ctx.saved_tensors
        bsz, _, d = x.shape
        dy = (torch.zeros_like(x) if dy is None
              else dy.float().contiguous())
        dh_final = (torch.zeros((bsz, d, a.shape[1]), dtype=torch.float32,
                                device=x.device) if dh_final is None
                    else dh_final.float().contiguous())
        return selective_scan_bwd(dt, x, b, c, a, hck, dy, dh_final)


def selective_scan_trainable(dt: torch.Tensor, x: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor,
                             a: torch.Tensor, h0: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan with its gradient from the backward kernel; float32
    inputs only."""
    if any(t.dtype != torch.float32 for t in (dt, x, b, c, a, h0)):
        raise TypeError("selective_scan_trainable: every input must be "
                        "float32 (the backward kernel takes float32)")
    return SelectiveScanFn.apply(dt, x, b, c, a, h0)


__all__ = ["MAX_STATE", "SelectiveScanFn", "describe", "selective_scan",
           "selective_scan_bwd", "selective_scan_fwd_ckpt",
           "selective_scan_trainable"]
