"""Spatial performance model for wafer-scale (and torus-ICI) fabrics.

Implements the paper's Eq. (1):

    T = max(C, E/N + L) + (2*T_R + 1) * D

over the four spatial cost terms

    D  depth       -- longest chain of sequentially dependent messages
    L  distance    -- hops travelled along the critical path
    E  energy      -- total element-hops injected into the fabric
    C  contention  -- max elements received (or sent) by any single PE

with N the number of links usable by the pattern and T_R the ramp
(processor<->router) latency.  All costs are in elements == cycles
(1 element/link/cycle on the WSE).

Two parameterizations are provided:

* ``WSE2`` -- the Cerebras CS-2 constants from the paper (T_R = 2).
* ``TPUv5eAxis`` -- re-parameterization of the same model for a TPU v5e ICI
  axis, used by the TPU collective selector (see DESIGN.md: hardware
  adaptation).  There, "cycles" are nanoseconds, a "link" is an ICI link,
  and T_R models per-hop SerDes/launch latency.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Hardware constants that parameterize the spatial model.

    ``link_bw`` is the link bandwidth in elements/cycle *relative to the
    model's unit link* (WSE: 1).  All wire-serialized terms scale by
    ``1 / link_bw``, so a ``link_bw=0.25`` axis prices its traffic 4x
    slower than a ``link_bw=1.0`` axis of the same topology -- the knob
    per-axis calibration uses to express "pod links are slower than
    intra-pod ICI" on a shared time base.
    """

    name: str
    t_r: float          # ramp latency (cycles) each way between PE and router
    store_cost: float   # cycles to store/add one received element
    link_bw: float = 1.0  # elements per cycle per link (WSE: 1)
    multicast: bool = True  # WSE routers replicate; ICI must software-fan-out
    t_launch: float = 0.0  # per-launch host/framework overhead (cycles):
    #                        dispatching one collective program, on top of
    #                        the wire-side t_r the depth term already pays.
    #                        0 until fitted (engine.calibrate_launch), so
    #                        the bandwidth-regime prices are unchanged.

    @property
    def per_depth_cost(self) -> float:
        """Cost charged per unit of depth: down-ramp + up-ramp + store."""
        return 2.0 * self.t_r + self.store_cost

    @property
    def hop_pipeline_cost(self) -> float:
        """Pipeline latency added per chain hop: link + ramps + add."""
        return 2.0 * self.t_r + 2.0


#: The paper's CS-2 parameterization (T_R measured to be 2, Sec. 2.2).
WSE2 = Fabric(name="wse2", t_r=2.0, store_cost=1.0)

#: A TPU v5e ICI axis viewed through the same model.  Units: one "element"
#: is one 512-byte ICI flit-group; one "cycle" is the time to push it over
#: one 45 GB/s usable link (~11.4 ns); t_r models the ~1 us per-launch
#: collective-permute latency expressed in those cycles.  These describe a
#: TPU, not an H100: the port keeps them only so that its decisions match
#: the reference's (NVLink constants wait for a calibration on the card).
TPU_V5E_AXIS = Fabric(name="tpu_v5e_axis", t_r=88.0, store_cost=1.0,
                      multicast=False)


def slowest_fabric(*fabrics: Fabric) -> Fabric:
    """Conservative pick for traffic that may traverse any of several
    link classes (a folded/flat schedule, the snake chain): the fabric
    with the worst bandwidth, ties broken by latency.  With identical
    fabrics this returns the first one, so uniform topologies price
    through the exact same object."""
    if not fabrics:
        raise ValueError("slowest_fabric() needs at least one fabric")
    return max(fabrics,
               key=lambda f: (1.0 / f.link_bw, f.t_r, f.store_cost,
                              f.t_launch))


@dataclasses.dataclass(frozen=True)
class FabricTopology:
    """Per-axis fabric constants for a heterogeneous mesh.

    Maps mesh axis *names* to the :class:`Fabric` whose constants price
    traffic on that axis's links; axes without an entry use ``default``.
    All per-axis fabrics must share one time base (one "cycle"), with
    relative link speed expressed through ``Fabric.link_bw`` -- that is
    what per-axis calibration produces.

    A uniform topology (no overrides) prices bit-for-bit identically to
    passing the bare ``default`` Fabric everywhere: every consumer takes
    the ``for_axis`` fast path that hands back the same object.
    """

    default: Fabric
    axis_fabrics: Tuple[Tuple[str, Fabric], ...] = ()
    name: str = ""

    def __post_init__(self):
        # normalize: duplicate axes collapse last-wins, overrides equal
        # to the default are dropped, and entries sort by axis name --
        # equality/hashing then ignore construction order
        merged = dict(self.axis_fabrics)
        kept = tuple(sorted(
            ((a, f) for a, f in merged.items() if f != self.default),
            key=lambda af: af[0]))
        object.__setattr__(self, "axis_fabrics", kept)
        if not self.name:
            object.__setattr__(self, "name", self.default.name)

    @classmethod
    def uniform(cls, fabric: Fabric) -> "FabricTopology":
        """Every axis priced with the same constants (the pre-topology
        behavior and the fast path)."""
        return cls(default=fabric)

    @property
    def is_uniform(self) -> bool:
        return not self.axis_fabrics

    def for_axis(self, axis: Union[str, Sequence[str], None]) -> Fabric:
        """Fabric for one mesh axis; a tuple (a folded logical axis)
        resolves to the slowest member, conservatively."""
        if axis is None:
            return self.default
        if isinstance(axis, (tuple, list)):
            return slowest_fabric(*(self.for_axis(a) for a in axis))
        for a, f in self.axis_fabrics:
            if a == axis:
                return f
        return self.default

    def with_axis(self, axis: str, fabric: Fabric) -> "FabricTopology":
        kept = tuple((a, f) for a, f in self.axis_fabrics if a != axis)
        return FabricTopology(default=self.default,
                              axis_fabrics=kept + ((axis, fabric),),
                              name=self.name)

    def describe(self) -> str:
        base = (f"{self.default.name}"
                f"(t_r={self.default.t_r:g}, bw={self.default.link_bw:g})")
        if self.is_uniform:
            return base
        per = ", ".join(f"{a}: t_r={f.t_r:g}, bw={f.link_bw:g}"
                        for a, f in self.axis_fabrics)
        return f"{base} [{per}]"


def as_topology(fabric: Union[Fabric, FabricTopology]) -> FabricTopology:
    if isinstance(fabric, FabricTopology):
        return fabric
    return FabricTopology.uniform(fabric)


#: named relative-speed presets for the CLI topology spec:
#: (link_bw multiplier, t_r multiplier) applied to the base fabric
FABRIC_PRESETS: Dict[str, Tuple[float, float]] = {
    "fast": (1.0, 1.0),        # the base axis fabric, unchanged
    "slow": (0.25, 4.0),       # 4x slower cross-pod link
    "dcn": (1.0 / 16.0, 16.0),  # data-center-network-ish inter-pod hop
}


def _fabric_from_dict(d: Dict, base: Fabric) -> Fabric:
    return Fabric(name=str(d.get("name", base.name)),
                  t_r=float(d.get("t_r", base.t_r)),
                  store_cost=float(d.get("store_cost", base.store_cost)),
                  link_bw=float(d.get("link_bw", base.link_bw)),
                  multicast=bool(d.get("multicast", base.multicast)),
                  t_launch=float(d.get("t_launch", base.t_launch)))


def parse_fabric_topology(spec: str,
                          base: Fabric = TPU_V5E_AXIS) -> FabricTopology:
    """Parse a CLI/JSON heterogeneous-topology spec.

    Two forms:

    * ``"pod=slow,data=fast"`` -- comma-separated ``axis=value`` pairs
      where ``value`` is a preset name (:data:`FABRIC_PRESETS`) or a
      bare float, read as a ``link_bw`` multiplier on ``base`` (so
      ``pod=0.25`` is a 4x-slower pod link).
    * a path to a JSON file ``{"default": {...}, "axes": {"pod": {...}}}``
      whose fabric dicts may set any of ``name/t_r/store_cost/link_bw/
      multicast`` (missing fields inherit from ``default``/``base``).
    """
    spec = spec.strip()
    if spec.endswith(".json") or os.path.isfile(spec):
        with open(spec) as f:
            payload = json.load(f)
        default = _fabric_from_dict(payload.get("default", {}), base)
        axes = tuple(
            (axis, _fabric_from_dict(d, default))
            for axis, d in sorted(payload.get("axes", {}).items()))
        return FabricTopology(default=default, axis_fabrics=axes)
    default = base
    axes = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"bad fabric spec entry {part!r}; expected "
                             f"axis=preset or axis=<link_bw multiplier>")
        axis, value = (s.strip() for s in part.split("=", 1))
        if value in FABRIC_PRESETS:
            bw_mult, tr_mult = FABRIC_PRESETS[value]
            suffix = value
        else:
            try:
                bw_mult, tr_mult = float(value), 1.0
            except ValueError:
                raise ValueError(
                    f"unknown fabric preset {value!r} for axis {axis!r}; "
                    f"have {sorted(FABRIC_PRESETS)} or a float "
                    f"link_bw multiplier") from None
            if bw_mult <= 0.0:
                raise ValueError(
                    f"link_bw multiplier for axis {axis!r} must be > 0, "
                    f"got {value!r}")
            suffix = f"bw{value}"
        if (bw_mult, tr_mult) == (1.0, 1.0):
            fab = base          # "fast"/1.0: the base fabric itself, so
                                # the axis stays on the uniform fast path
        else:
            fab = dataclasses.replace(base, name=f"{base.name}_{suffix}",
                                      link_bw=base.link_bw * bw_mult,
                                      t_r=base.t_r * tr_mult)
        if axis == "default":
            default = fab
        else:
            axes.append((axis, fab))
    return FabricTopology(default=default, axis_fabrics=tuple(axes))


@dataclasses.dataclass(frozen=True)
class CostTerms:
    """Spatial cost decomposition of one collective pattern instance."""

    depth: float
    distance: float
    energy: float
    contention: float
    links: float
    label: str = ""
    launches: float = 0.0   # sequential program launches the pattern
    #                         issues; each pays Fabric.t_launch

    def cycles(self, fabric: Fabric = WSE2) -> float:
        """Paper Eq. (1), with wire terms scaled by the link bandwidth
        and ``launches`` program dispatches each paying ``t_launch``."""
        bw = fabric.link_bw
        if self.links <= 0:
            bandwidth_term = self.distance
        else:
            bandwidth_term = self.energy / (self.links * bw) + self.distance
        return (
            max(self.contention / bw, bandwidth_term)
            + fabric.per_depth_cost * self.depth
            + fabric.t_launch * self.launches
        )

    def dominant_term(self, fabric: Fabric = WSE2) -> str:
        """Name of the largest contributor (for analysis/reporting)."""
        bw = fabric.link_bw
        bandwidth = (self.energy / (self.links * bw)
                     if self.links > 0 else 0.0)
        parts = {
            "contention": self.contention / bw,
            "bandwidth": bandwidth,
            "distance": self.distance,
            "depth": fabric.per_depth_cost * self.depth,
            "launch": fabric.t_launch * self.launches,
        }
        return max(parts, key=parts.get)


def validate_positive(p: int, b: int) -> None:
    if p < 1:
        raise ValueError(f"need at least one PE, got P={p}")
    if b < 1:
        raise ValueError(f"need vector length >= 1, got B={b}")


def is_power_of_two(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def log2i(x: int) -> int:
    if not is_power_of_two(x):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


__all__ = [
    "Fabric",
    "FabricTopology",
    "WSE2",
    "TPU_V5E_AXIS",
    "CostTerms",
    "as_topology",
    "slowest_fabric",
    "parse_fabric_topology",
    "FABRIC_PRESETS",
    "validate_positive",
    "is_power_of_two",
    "log2i",
    "ceil_div",
]
