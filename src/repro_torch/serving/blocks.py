"""Fixed-size KV block allocator with refcounted, evictable blocks.

The physical cache (``repro_torch.models.paged.init_pages``) is a pool of
``num_blocks`` blocks of ``block_size`` token slots each.  The allocator
hands out block ids; per-request ownership is a ``BlockTable`` (the
logical-order id list the model indexes with).  Block 0 is reserved as
the scratch sink for writes from padded/inactive rows and is never
allocated.

Every granted block carries a **refcount** so one physical block can
appear in many logical tables (content-addressed prefix sharing,
``serving/prefix_cache.py``).  A block lives in exactly one of three
states:

* **live** -- refcount >= 1, referenced by at least one table;
* **evictable** -- refcount 0 but registered as holding cached prefix
  content (``register_cached``): it stays resident so a future request
  can revive it with ``ref``, and is reclaimed LRU-first only under
  pool pressure;
* **free** -- no content worth keeping.

Allocation is all-or-nothing over ``free + evictable`` (``alloc(n)``
returns ``None`` when fewer than n are reclaimable) so the scheduler
can make admit/preempt decisions atomically.  Blocks are fixed-size, so
there is no external fragmentation; the only waste is *internal* (tail
slots of a request's last block), reported by
``internal_fragmentation`` over *unique* physical blocks (a shared
prefix block's tail is counted once, not once per table).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

RESERVED_BLOCKS = 1     # block 0: scratch sink for invalid writes

#: one live request's block usage: (block ids in logical order, context
#: length in tokens).  A bare int is the legacy no-sharing form.
BlockUsage = Union[int, Tuple[List[int], int]]


class BlockAllocator:
    """Refcounted free-list over the physical block pool with an LRU
    evictable tier for refcount-0 cached blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < RESERVED_BLOCKS + 1:
            raise ValueError(f"need > {RESERVED_BLOCKS} blocks, "
                             f"got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO keeps recently-freed (cache-warm) blocks hot
        self._free: List[int] = list(range(num_blocks - 1,
                                           RESERVED_BLOCKS - 1, -1))
        self._used: set[int] = set()
        self._ref: Dict[int, int] = {}
        # refcount-0 cached blocks, LRU order (first = evict next);
        # value is the content key registered for the block
        self._evictable: "OrderedDict[int, bytes]" = OrderedDict()
        # content key while the block holds registered cache content
        # (live or evictable)
        self._cached_key: Dict[int, bytes] = {}
        #: called as hook(block, key) when an evictable block is
        #: reclaimed, so the prefix cache can drop its mapping
        self.evict_hook: Optional[Callable[[int, bytes], None]] = None
        self.evictions = 0

    @property
    def capacity(self) -> int:
        """Allocatable blocks (pool minus the scratch block)."""
        return self.num_blocks - RESERVED_BLOCKS

    @property
    def num_free(self) -> int:
        """Blocks with no retained content (excludes evictable)."""
        return len(self._free)

    @property
    def num_evictable(self) -> int:
        """Refcount-0 cached blocks resident until pool pressure."""
        return len(self._evictable)

    @property
    def num_available(self) -> int:
        """Blocks an ``alloc`` can grant: free plus evictable."""
        return len(self._free) + len(self._evictable)

    @property
    def num_used(self) -> int:
        """Live blocks (refcount >= 1)."""
        return len(self._used)

    @property
    def occupancy(self) -> float:
        return self.num_used / max(1, self.capacity)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-max(num_tokens, 0) // self.block_size)

    # ------------------------------------------------------------------ #
    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """n fresh block ids at refcount 1, or None if fewer than n are
        reclaimable (no partial grants).  Free blocks are taken first;
        under pressure, evictable cached blocks are reclaimed LRU-first
        (``evict_hook`` fires per reclaimed block)."""
        if n < 0:
            raise ValueError(n)
        if n > self.num_available:
            return None
        out = []
        for _ in range(n):
            if self._free:
                blk = self._free.pop()
            else:
                blk, key = self._evictable.popitem(last=False)   # LRU
                del self._cached_key[blk]
                self.evictions += 1
                if self.evict_hook is not None:
                    self.evict_hook(blk, key)
            self._used.add(blk)
            self._ref[blk] = 1
            out.append(blk)
        return out

    def ref(self, block: int) -> None:
        """Add a reference: bump a live block, or revive an evictable
        cached block back to refcount 1 (content retained)."""
        if block in self._used:
            self._ref[block] += 1
        elif block in self._evictable:
            self._evictable.pop(block)
            self._used.add(block)
            self._ref[block] = 1
        else:
            raise ValueError(f"ref of unallocated block {block}")

    def decref(self, block: int) -> None:
        """Drop one reference.  At refcount 0 a cached block parks on
        the evictable LRU (most-recently-used end); an uncached block
        returns to the free list."""
        if block not in self._used:
            raise ValueError(f"double free or foreign block {block}")
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return
        del self._ref[block]
        self._used.remove(block)
        key = self._cached_key.get(block)
        if key is not None:
            self._evictable[block] = key        # MRU end
        else:
            self._free.append(block)

    def free(self, blocks: Iterable[int]) -> None:
        """Release one reference per block (legacy bulk ``decref``)."""
        for blk in blocks:
            self.decref(blk)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    # ------------------------------------------------------------------ #
    def register_cached(self, block: int, key: bytes) -> None:
        """Mark a live block as holding immutable cached content
        addressed by ``key``; from now on refcount 0 parks it on the
        evictable LRU instead of the free list."""
        if block not in self._used:
            raise ValueError(f"register_cached of non-live block {block}")
        self._cached_key[block] = key

    def is_cached(self, block: int) -> bool:
        return block in self._cached_key

    def cached_key(self, block: int) -> Optional[bytes]:
        return self._cached_key.get(block)

    # ------------------------------------------------------------------ #
    def internal_fragmentation(self, usage: Iterable[BlockUsage]) -> int:
        """Allocated-but-unused token slots over *unique* physical
        blocks.

        Each entry is ``(block ids, context length)`` for one live
        request; a block referenced by several tables (shared prefix)
        counts its tail waste once, at the deepest fill any table gives
        it.  A bare int entry is the legacy no-sharing form (minimal
        block count assumed).
        """
        per_block: Dict[int, int] = {}
        waste = 0
        for item in usage:
            if isinstance(item, int):
                waste += self.blocks_for(item) * self.block_size - item
                continue
            blocks, n = item
            for j, blk in enumerate(blocks):
                toks = min(self.block_size, n - j * self.block_size)
                toks = max(toks, 0)
                per_block[blk] = max(per_block.get(blk, 0), toks)
        waste += sum(self.block_size - t for t in per_block.values())
        return waste


class BlockTable:
    """One request's logical-order block ids (each entry holds one
    reference; shared prefix blocks appear in many tables)."""

    def __init__(self, allocator: BlockAllocator):
        self._alloc = allocator
        self.blocks: List[int] = []

    @property
    def num_slots(self) -> int:
        return len(self.blocks) * self._alloc.block_size

    def grow(self, n_blocks: int) -> bool:
        got = self._alloc.alloc(n_blocks)
        if got is None:
            return False
        self.blocks.extend(got)
        return True

    def ensure_capacity(self, num_tokens: int) -> bool:
        need = self._alloc.blocks_for(num_tokens) - len(self.blocks)
        return need <= 0 or self.grow(need)

    def release(self) -> None:
        """Drop this table's references (``decref``, not free: shared
        prefix blocks survive their first owner, cached blocks park on
        the evictable LRU)."""
        if self.blocks:
            for blk in self.blocks:
                self._alloc.decref(blk)
            self.blocks = []


__all__ = ["RESERVED_BLOCKS", "BlockAllocator", "BlockTable",
           "BlockUsage"]
