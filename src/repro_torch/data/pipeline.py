"""Deterministic synthetic LM data pipeline (counterpart of
``repro/data/pipeline.py``; numpy only, so its batches are bit-identical
to the reference's).

Token batches are keyed by (seed, step, shard) with a counter-based RNG,
so every host can materialise exactly its own shard without
coordination, and a restart replays the same order.  The "documents" are
Zipf-ish token streams with a simple Markov flavour, so cross-entropy
actually decreases during a run (a uniform stream has nothing to learn).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


class SyntheticLMDataset:
    """Stateless map-style dataset: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig, num_shards: int = 1,
                 shard_index: int = 0):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.local_batch = cfg.global_batch // num_shards
        # Zipf-ish unigram table (fixed by seed)
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_alpha)
        self._probs = probs / probs.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Tokens + next-token labels for this shard at `step`."""
        c = self.cfg
        rng = np.random.default_rng(
            (c.seed, step, self.shard_index, 0xD47A))
        shape = (self.local_batch, c.seq_len + 1)
        draws = rng.choice(c.vocab_size, size=shape, p=self._probs)
        toks = self._perm[draws]
        # Markov flavour: even positions copy their predecessor w.p. 1/2
        copy = rng.random(shape) < 0.5
        copy[:, 0] = False
        toks = np.where(copy, np.roll(toks, 1, axis=1), toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


__all__ = ["DataConfig", "SyntheticLMDataset"]
