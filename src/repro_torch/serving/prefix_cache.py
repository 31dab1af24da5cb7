"""Content-addressed prefix cache over the paged KV block pool.

Requests that share a prompt prefix (system prompts under multi-tenant
traffic) share the *physical* KV blocks holding it instead of
recomputing them: the block-table indirection already lets one physical
block appear in many logical tables, so sharing is pure host-side
bookkeeping -- no kernel or model change.

**Addressing.**  Block ``i`` of a token stream is addressed by a hash
chain at block granularity::

    key_i = H(key_{i-1}, token_ids[i*bs : (i+1)*bs])

so a key commits to the *entire* prefix through block ``i``, not just
the block's own tokens -- two streams sharing key_i share every token
up to ``(i+1)*bs``.  Only *full* blocks are cacheable: a partial tail
block is still mutable (decode appends into it) and is never shared.

**Lifecycle.**  ``match`` walks the chain and returns the longest run
of resident blocks, taking one reference on each (reviving evictable
blocks).  ``insert`` registers a fully-written block under its key;
first writer wins -- a concurrent duplicate keeps its private copy
uncached.  When a block's refcount drops to zero it parks on the
allocator's evictable LRU (content retained) and is reclaimed only
under pool pressure; the allocator's evict hook removes the mapping
here, so the map never dangles.  Evicting a chain-interior block
orphans its descendants (the chain walk stops early); they age out of
the LRU naturally.

Vision requests (``soft_emb``) are not cached: their prefix content is
not a pure function of token ids.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.blocks import BlockAllocator

#: chain seed; bump when the key schema changes
_CHAIN_SEED = b"repro-prefix-cache-v1"


def chain_keys(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Hash-chain keys for every *full* block of ``tokens``."""
    keys: List[bytes] = []
    prev = _CHAIN_SEED
    toks = np.asarray(tokens, np.int32)
    for i in range(len(toks) // block_size):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(toks[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class PrefixCache:
    """key -> physical block map over a refcounted ``BlockAllocator``."""

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self._map: Dict[bytes, int] = {}
        allocator.evict_hook = self._on_evict
        self.hits = 0           # blocks served from cache
        self.misses = 0         # chain lookups that stopped the walk
        self.inserts = 0

    def __len__(self) -> int:
        return len(self._map)

    @property
    def evictions(self) -> int:
        return self.allocator.evictions

    def _on_evict(self, block: int, key: bytes) -> None:
        # eviction reclaims the block for new content: drop the mapping
        # (the block may have been re-inserted under a newer key since,
        # so only remove an exact match)
        if self._map.get(key) == block:
            del self._map[key]

    def keys_for(self, tokens: Sequence[int]) -> List[bytes]:
        return chain_keys(tokens, self.block_size)

    def probe(self, keys: Sequence[bytes]) -> int:
        """Resident-prefix length in *blocks* without taking references
        or touching the hit/miss counters -- the read-only prediction a
        fleet router uses to score replicas.  A block counted here may
        still be evicted before the request lands (the prediction is a
        routing hint, not a reservation)."""
        n = 0
        for key in keys:
            if key not in self._map:
                break
            n += 1
        return n

    def match(self, keys: Sequence[bytes]) -> List[int]:
        """Longest cached prefix of the key chain; every returned block
        has one reference taken on behalf of the caller (so a
        concurrent admission cannot evict it)."""
        out: List[int] = []
        for key in keys:
            blk = self._map.get(key)
            if blk is None:
                self.misses += 1
                break
            self.allocator.ref(blk)
            out.append(blk)
        self.hits += len(out)
        return out

    def insert(self, key: bytes, block: int) -> bool:
        """Register a fully-written live block under ``key``.  Returns
        False (leaving the block private) when the key is already
        mapped -- first writer wins."""
        if key in self._map:
            return False
        self._map[key] = block
        self.allocator.register_cached(block, key)
        self.inserts += 1
        return True


__all__ = ["PrefixCache", "chain_keys"]
