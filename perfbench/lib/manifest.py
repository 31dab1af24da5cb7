"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file and the readers of its
per-layer metrics.  A later change adds a configuration, a traffic mix,
a cell or a metric as new files and entries; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    read: Optional[Callable] = None     # per-layer metrics only


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    why: str
    config: dict          # the configuration file, as it is run
    traffic_name: str
    traffic: dict         # the traffic file
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_reader(name: str) -> Callable:
    """``perfbench/metrics/<name>.py``'s ``read``."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: Path = ROOT) -> Cell:
    m = manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in m["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(PERFBENCH / "traffic" / f"{w['traffic']}.json")
    e2e = [Metric(e["name"], e["unit"], e["better"], e["source"])
           for e in m["end_to_end"] if _applies(e, name)]
    reported = {e.name for e in e2e}
    per_layer = [Metric(p["name"], p["unit"], p["better"], p["source"],
                        p["layer"], p["moves"], load_reader(p["name"]))
                 for p in m["per_layer"]
                 if _applies(p, name) and p["moves"] in reported]
    return Cell(name, w["chips"], w["why"], config, w["traffic"], traffic,
                e2e, per_layer)
