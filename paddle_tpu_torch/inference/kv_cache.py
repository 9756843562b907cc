"""Block-table paged KV cache: the host-side allocator and the prefix
index (port of ``paddle_tpu/inference/kv_cache.py``, behaviour bit for
bit).

The device holds ONE preallocated pool per layer-stacked k/v
([L, num_blocks, KV*HD, block_size], see models/llama.py
init_paged_kv_pool); sequences own sets of blocks named by per-sequence
int32 block tables, and every alloc/free decision happens here on the
host: the device path never reshapes, compacts or copies a cache (the
engine's copy-on-write blit aside).

Block 0 is the reserved NULL block: it is never allocated, every padding
row of a bucketed decode batch points its whole table at it, and padding
columns land there. Its contents are unspecified: no attention path lets
a column of block 0 into a product.

  - **Per-block ref counts**: a block may be owned by several sequences
    at once (copy-on-write prefix sharing). ``free()`` on a block with
    refs > 1 decrements; a double decrement raises
    :class:`BlockPoolError` before mutating anything; ``used_blocks``
    counts a shared block ONCE.
  - **A cached-LRU parking lot**: a block registered in the
    :class:`PrefixCache` whose ref count drops to zero is PARKED (kept
    byte-intact for future prefix hits) instead of freed. ``alloc()``
    drains the true free list first and only then reclaims parked blocks
    oldest-first, so caching never steals capacity from live sequences.
"""
from __future__ import annotations

from collections import Counter, OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class BlockPoolError(ValueError):
    """A caller violated the pool's ownership contract: double free,
    out-of-range id, or the reserved null block."""


class BlockPool:
    """Ref-counted free-list allocator over ``num_blocks`` fixed-size
    blocks.

    O(1) alloc/free via a LIFO free list; all-or-nothing allocation so
    a failed admission never leaks partial sets. Block 0 is reserved
    (the null block) and never handed out; ``free()`` validates every
    id — including duplicates WITHIN one call — before mutating
    anything, so a rejected free leaves the pool untouched.

    Blocks marked cache-resident (``mark_cached``, driven by the
    PrefixCache) park in an LRU dict when their last reference drops;
    ``reclaim_cb`` fires when ``alloc()`` repurposes a parked block so
    the index can forget it."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"BlockPool needs >= 2 blocks (one is the reserved null "
                f"block), got {num_blocks}")
        if block_size < 1 or block_size % 128:
            raise ValueError(
                f"block_size must be a positive multiple of 128, "
                f"got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO keeps recently-freed (cache-warm) blocks in circulation
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_set = set(self._free)
        self._refs: Dict[int, int] = {}            # live blocks only
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU->MRU
        self._cache_flag: set = set()              # prefix-index members
        self.reclaim_cb: Optional[Callable[[int], None]] = None

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        """Parked prefix-cache blocks: zero refs, byte-intact, reclaimed
        LRU-oldest-first only after the free list runs dry."""
        return len(self._cached)

    @property
    def available_blocks(self) -> int:
        """Blocks an ``alloc()`` can hand out right now (free + parked)."""
        return len(self._free) + len(self._cached)

    @property
    def used_blocks(self) -> int:
        """Blocks with at least one live reference — a block shared by
        N sequences counts ONCE (the leak audit's contract)."""
        return (self.num_blocks - 1) - len(self._free) - len(self._cached)

    @property
    def utilization(self) -> float:
        return self.used_blocks / max(self.num_blocks - 1, 1)

    def ref_count(self, block: int) -> int:
        return self._refs.get(block, 0)

    def is_registered(self, block: int) -> bool:
        """True while ``block`` backs a PrefixCache entry (live or
        parked)."""
        return block in self._cache_flag

    def can_alloc(self, n: int) -> bool:
        return n <= self.available_blocks

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (and no state change) if the pool is dry.
        Drains the free list first; then reclaims parked cache blocks
        oldest-first, notifying ``reclaim_cb`` for each so the prefix
        index drops the reclaimed entry."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.available_blocks:
            return None
        take = min(n, len(self._free))
        got = self._free[len(self._free) - take:] if take else []
        del self._free[len(self._free) - take:]
        self._free_set.difference_update(got)
        while len(got) < n:
            b, _ = self._cached.popitem(last=False)   # LRU-oldest
            self._cache_flag.discard(b)
            if self.reclaim_cb is not None:
                self.reclaim_cb(b)
            got.append(b)
        for b in got:
            self._refs[b] = 1
        return got

    def acquire(self, blocks: Sequence[int]) -> None:
        """Take one reference on each block of a prefix-cache hit: a
        parked block comes back live (refs=1, still index-registered),
        a live block's count increments. Validates every id before
        mutating anything."""
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise BlockPoolError(f"acquire of out-of-range block {b}")
            if b not in self._refs and b not in self._cached:
                raise BlockPoolError(
                    f"acquire of free block {b} (not live or parked)")
        for b in blocks:
            if b in self._cached:
                del self._cached[b]
                self._refs[b] = self._refs.get(b, 0) + 1
            else:
                self._refs[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block. A block's LAST reference
        either parks it (if prefix-registered) or returns it to the free
        list. Every id — including duplicates within this call — is
        validated against the live ref counts BEFORE anything mutates,
        so a rejected free leaves the pool untouched."""
        counts = Counter(blocks)
        for b, n in counts.items():
            if b == 0:
                raise BlockPoolError(
                    "free of the reserved null block 0")
            if not 1 <= b < self.num_blocks:
                raise BlockPoolError(f"free of out-of-range block {b}")
            if self._refs.get(b, 0) < n:
                raise BlockPoolError(f"double free of block {b}")
        for b, n in counts.items():
            left = self._refs[b] - n
            if left:
                self._refs[b] = left
            else:
                del self._refs[b]
                if b in self._cache_flag:
                    self._cached[b] = None           # park at MRU end
                else:
                    self._free.append(b)
                    self._free_set.add(b)

    def mark_cached(self, block: int) -> None:
        """Flag a LIVE block as prefix-cache-resident: when its last
        reference drops it parks instead of freeing."""
        if self._refs.get(block, 0) < 1:
            raise BlockPoolError(
                f"mark_cached of non-live block {block}")
        self._cache_flag.add(block)

    def unmark_cached(self, block: int) -> None:
        """Withdraw a block from cache residency (index invalidation).
        A parked block goes straight back to the free list."""
        self._cache_flag.discard(block)
        if block in self._cached:
            del self._cached[block]
            self._free.append(block)
            self._free_set.add(block)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` occupies."""
        return -(-max(n_tokens, 0) // self.block_size)


class PrefixCache:
    """Token-exact prefix index over a :class:`BlockPool`.

    Maps the EXACT cumulative token tuple of each full block —
    ``tuple(tokens[:i * block_size])`` — to the pool block holding its
    KV bytes. Exact tuples (not hashes) rule out collision reuse of
    wrong-token blocks; memory is bounded by the pool itself since an
    entry dies with its block's reclaim. ``match`` walks the longest
    chain of consecutive full-block keys; the engine acquires those
    blocks (copy-on-write — see InferenceEngine._cow_span) and skips
    prefill for the hit span.

    Cache state is DERIVED, never journaled: a block's bytes are a
    deterministic function of its token prefix (greedy decode + the
    per-column quantizer), so recovery re-deriving from the journal is
    bit-identical whether a prefix hit or a cold prefill produced them.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        pool.reclaim_cb = self._on_reclaim
        self._index: Dict[Tuple[int, ...], int] = {}
        self._owner: Dict[int, Tuple[int, ...]] = {}
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.registered = 0
        self.reclaimed = 0
        self.invalidated = 0

    def __len__(self) -> int:
        return len(self._index)

    def _keys(self, tokens: Sequence[int], limit_blocks: int
              ) -> List[Tuple[int, ...]]:
        bs = self.pool.block_size
        n = min(int(limit_blocks), len(tokens) // bs)
        return [tuple(int(t) for t in tokens[:i * bs])
                for i in range(1, n + 1)]

    def match(self, tokens: Sequence[int], limit_blocks: int
              ) -> List[int]:
        """Longest chain of cached full blocks prefixing ``tokens``
        (block-aligned; at most ``limit_blocks``). Counts stats; the
        caller still owns nothing until it ``acquire``s the result."""
        self.lookups += 1
        blocks: List[int] = []
        for key in self._keys(tokens, limit_blocks):
            b = self._index.get(key)
            if b is None:
                break
            blocks.append(b)
        if blocks:
            self.hits += 1
            self.hit_tokens += len(blocks) * self.pool.block_size
        return blocks

    def match_len(self, tokens: Sequence[int], limit_blocks: int,
                  pending: Optional[set] = None) -> int:
        """Stat-free match length for admission estimates; ``pending``
        holds prospective keys of not-yet-prefilled queued prompts, so
        a same-instant burst of identical prompts already counts as
        shared."""
        n = 0
        for key in self._keys(tokens, limit_blocks):
            if key in self._index or (pending is not None
                                      and key in pending):
                n += 1
            else:
                break
        return n

    def prospective_keys(self, tokens: Sequence[int],
                         limit_blocks: int) -> List[Tuple[int, ...]]:
        """The full-block keys ``tokens`` WILL register once prefilled
        (admission-estimate helper)."""
        return self._keys(tokens, limit_blocks)

    def register(self, tokens: Sequence[int], blocks: Sequence[int],
                 n_blocks: int) -> int:
        """Index ``blocks[:n_blocks]`` under the cumulative keys of
        ``tokens``. First writer wins per key (a concurrent identical
        prompt's private blocks simply stay unregistered); a block
        already owning a different key is skipped. Returns entries
        added."""
        added = 0
        for i, key in enumerate(self._keys(tokens, n_blocks)):
            b = int(blocks[i])
            if key in self._index or b in self._owner:
                continue
            self._index[key] = b
            self._owner[b] = key
            self.pool.mark_cached(b)
            self.registered += 1
            added += 1
        return added

    def invalidate_block(self, block: int) -> None:
        """Drop the entry backed by ``block`` (engine COW guard: a
        write into a registered ref-1 block would corrupt the index's
        bytes, so the entry is forgotten instead)."""
        key = self._owner.pop(block, None)
        if key is not None:
            self._index.pop(key, None)
            self.invalidated += 1
        self.pool.unmark_cached(block)

    def _on_reclaim(self, block: int) -> None:
        key = self._owner.pop(block, None)
        if key is not None:
            self._index.pop(key, None)
            self.reclaimed += 1

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._index),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "hit_tokens": self.hit_tokens,
            "registered": self.registered,
            "reclaimed": self.reclaimed,
            "invalidated": self.invalidated,
        }


def pad_table(blocks: List[int], max_nb: int) -> np.ndarray:
    """A sequence's block list as a fixed-width table row; unallocated
    slots point at the null block."""
    if len(blocks) > max_nb:
        raise ValueError(
            f"sequence holds {len(blocks)} blocks > table width {max_nb}")
    row = np.zeros((max_nb,), np.int32)
    row[:len(blocks)] = blocks
    return row


def pool_bytes_per_rank(pools: Sequence, mp: int = 1) -> int:
    """Device bytes ONE rank holds for the given KV/scale tensors (``None``
    entries, absent scale or draft pools, are skipped): their bytes over
    ``mp``, for pools that ``mp`` ranks split evenly (JAX's global arrays).
    The port's engine passes its own rank's pools, with ``mp`` 1."""
    total = 0
    for p in pools:
        if p is None:
            continue
        total += int(p.numel()) * int(p.element_size())
    return total // max(1, int(mp))
