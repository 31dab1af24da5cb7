"""BENCHMARK.json against the benchmark's contract, and every file a
cell names found by its name."""

import json
import re

import pytest

from perfbench.lib import manifest

M = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert len(json.dumps(M)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    r = M["run_seconds"]
    assert 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key]), (key, entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_directions(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = ({"host_clock", "device_trace"} if "bound" in metric else
               {"host_clock", "device_trace", "program_span",
                "program_counter"})
    assert metric["source"] in allowed


def test_names_are_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", M["end_to_end"], ids=lambda m: m["name"])
def test_bounds(metric):
    assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"] == "setup_s":
        assert metric["bound"] == 0.25


def test_four_card_cells_are_few():
    fours = sum(w["chips"] == 4 for w in M["workloads"])
    assert fours <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    c = manifest.load_cell(cell)
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "a cell reports at least one per-layer metric"


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_an_end_to_end_metric_of_its_cells(metric):
    e2e = {m["name"]: m for m in M["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert "workloads" not in moved or cell in moved["workloads"]


def test_layers_are_named_alike():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


@pytest.mark.parametrize("cell", CELLS)
def test_files_are_found_by_name(cell):
    w = {w["name"]: w for w in M["workloads"]}[cell]
    configs = {c["name"]: c for c in M["configs"]}
    cfg = manifest.load_json(manifest.ROOT / configs[w["config"]]["file"])
    assert cfg["name"] == w["config"] and "arch" in cfg
    assert (manifest.PERFBENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (manifest.PERFBENCH / "workloads" / f"{cell}.json").is_file()
    c = manifest.load_cell(cell)
    assert all(callable(m.read) for m in c.per_layer)


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("perfbench/")
    body = manifest.load_json(manifest.ROOT / config["file"])
    assert body["source"] == config["source"]
    assert body["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert not re.search(r"(_dim|_rank|size|heads|width)$", key)


def test_every_config_is_used():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
