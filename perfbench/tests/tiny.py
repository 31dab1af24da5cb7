"""Cells of the benchmark at a size a CPU test run holds: the same
driver, traffic kind and comparison, tiny widths."""

from __future__ import annotations

import copy

from perfbench.lib import manifest

DENSE = {"name": "tiny-dense", "family": "dense", "num_layers": 2,
         "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "head_dim": 16,
         "d_ff": 128, "vocab_size": 256, "rope_theta": 10000.0,
         "norm_eps": 1e-6, "dtype": "float32"}

TRAIN = "minicpm-2b.train-4k"


def traffic(name: str) -> dict:
    return manifest.load_json(manifest.PERFBENCH / "traffic"
                              / f"{name}.json")


def train_cell(**over) -> manifest.Cell:
    tr = traffic("train-4k")
    tr.update(rows=2, seq=32)
    tr.update(over)
    proto = manifest.load_cell(TRAIN)
    return manifest.Cell("tiny.train", 1, proto.why,
                         {"arch": copy.deepcopy(DENSE)}, "train-4k", tr,
                         proto.end_to_end, proto.per_layer)
