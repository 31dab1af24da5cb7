"""Roofline-term derivation from compiled dry-run artifacts.

    compute term    = FLOPs_per_device / peak_FLOPs_per_chip
    memory term     = HBM_bytes_per_device / HBM_bw_per_chip
    collective term = collective_bytes_per_device / link_bw

The compiled module is the post-SPMD per-device program, so
``cost_analysis()`` FLOPs/bytes and the HLO collective operand sizes are
*per-device* quantities; dividing by per-chip peaks gives seconds
directly (equivalent to the global/(chips*peak) form in the task spec).

Hardware constants: TPU v5e -- 197 bf16 TFLOP/s, 819 GB/s HBM,
~50 GB/s/link ICI.

The port's copy of ``repro/launch/roofline.py``, constants and all: they
describe a TPU v5e, not the GPU the port runs on (ROADMAP.md C8).  The
fleet's ``cost`` router prices prefill with ``PEAK_FLOPS``, so its
routing equals the reference's.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

PEAK_FLOPS = 197e12        # bf16 FLOP/s per chip (TPU v5e)
HBM_BW = 819e9             # bytes/s per chip (TPU v5e)
LINK_BW = 50e9             # bytes/s per ICI link (TPU v5e)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    nbytes = _DTYPE_BYTES.get(dtype)
    if nbytes is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * nbytes


def parse_collective_bytes(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Sum result-shape bytes of every collective op in (post-SPMD) HLO.

    Returns {op_kind: {"bytes": b, "count": n}}.
    """
    out: Dict[str, Dict[str, float]] = {
        k: {"bytes": 0.0, "count": 0} for k in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if "=" not in stripped:
            continue
        lhs, _, rhs = stripped.partition("=")
        rhs = rhs.strip()
        for op in COLLECTIVE_OPS:
            # match ` = <shape(s)> op-name(' with optional `-start` /
            # `-done`.  `=` must be in the shape class: big tuple
            # results carry `/*index=5*/` comments (e.g. the 8-operand
            # all-to-all), and `(` is excluded, so the lazy match still
            # cannot cross into an op's operand list.
            m = re.match(
                r"^(\(?[\w\[\],{}\s/#*=]*?\)?)\s*%?" + op + r"(-start)?\(",
                rhs)
            if m:
                if m.group(2):  # async start: count here, skip the -done
                    shapes_src = m.group(1)
                else:
                    shapes_src = m.group(1)
                b = sum(_shape_bytes(d, dims)
                        for d, dims in _SHAPE_RE.findall(shapes_src))
                out[op]["bytes"] += b
                out[op]["count"] += 1
                break
    return out


def collective_total(parsed: Dict[str, Dict[str, float]]) -> float:
    return sum(v["bytes"] for v in parsed.values())


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_global: float
    hlo_flops_global: float
    n_devices: int = 1

    @property
    def dominant(self) -> str:
        parts = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(parts, key=parts.get)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs -- catches remat/redundancy/padding."""
        if self.hlo_flops_global <= 0:
            return float("nan")
        return self.model_flops_global / self.hlo_flops_global

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute seconds / bottleneck seconds (== achievable MFU
        if the dominant term were perfectly overlapped with the rest)."""
        if self.total_s <= 0:
            return float("nan")
        useful_s = self.model_flops_global / (self.n_devices * PEAK_FLOPS)
        return useful_s / self.total_s

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_global": self.model_flops_global,
            "hlo_flops_global": self.hlo_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   collective_bytes_per_device: float, n_devices: int,
                   model_flops_global: float) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_device / PEAK_FLOPS,
        memory_s=hbm_bytes_per_device / HBM_BW,
        collective_s=collective_bytes_per_device / LINK_BW,
        model_flops_global=model_flops_global,
        hlo_flops_global=flops_per_device * n_devices,
        n_devices=n_devices,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
    n_active = cfg.active_param_count()
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


__all__ = [
    "PEAK_FLOPS", "HBM_BW", "LINK_BW", "COLLECTIVE_OPS",
    "parse_collective_bytes", "collective_total", "RooflineTerms",
    "roofline_terms", "model_flops",
]
