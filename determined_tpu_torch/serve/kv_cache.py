"""Paged KV-cache block allocator: the host-side half of PagedAttention.

A copy of ``determined_tpu/serve/kv_cache.py``.

The device arrays (``models/transformer.py init_kv_cache``) are a flat pool
of fixed-size blocks; this module owns WHICH blocks belong to WHOM.  A
ref-counted free-list allocator hands out physical block ids all-or-nothing
per sequence (admission either fits a whole worst-case request or rejects
it — no mid-flight OOM aborting a half-generated response), and releases
them the moment the sequence retires, so cache capacity — not lane count —
is the real admission limit under long-context load.

Prefix caching (vLLM-style, Kwon et al. SOSP'23) rides the same allocator:
every FULL block of a prompt is content-addressed by the hash chain
``h_i = hash((h_{i-1}, tokens_i))`` — each link covers one block's tokens
and transitively its whole prefix, so a flat ``hash -> physical block``
map IS a prefix trie (a child is only reachable through its parent's
hash).  Admission walks the chain and maps the longest cached run of
physical blocks into the new sequence's table with an incref per block;
only the un-cached suffix is prefilled.  Shared blocks are strictly
read-only: the partial tail block (and the block holding the final prompt
token, which the first decode write may touch) is never aliased — it is
copy-on-write in the recompute sense, re-prefilled into a private block.
When a sequence retires, registered blocks whose refcount hits zero move
to a resident LRU pool instead of the free list; they stay matchable and
are evicted (oldest first) only when ``alloc`` runs out of truly free
blocks.  Eviction therefore never touches a block with live references.

Block 0 is reserved as the scratch block padded prefill positions and
inactive decode lanes write into (static scatter shapes, no masking in the
kernel); it is never handed out and never freed.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

#: root of every hash chain — an arbitrary odd constant so the first
#: block's hash differs from hash of its tokens alone
_HASH_ROOT = 0x9E3779B97F4A7C15


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks a sequence of ``n_tokens`` spans — THE sizing formula.
    ServeConfig validation and the allocator both call this one function,
    so admission limits and placement can never disagree."""
    return -(-max(int(n_tokens), 1) // block_size)


def prefix_block_hashes(
    tokens: Sequence[int], block_size: int, limit_tokens: Optional[int] = None
) -> List[Tuple[int, Tuple[int, ...]]]:
    """Hash chain over the FULL blocks of ``tokens``: ``[(h_i, chunk_i)]``.

    Only complete blocks participate (a partial tail is never shared), and
    ``limit_tokens`` caps how many tokens the chain may cover — admission
    passes ``len(prompt) - 1`` so at least the final prompt token is always
    re-prefilled privately (its logits seed sampling, and the first decode
    write can land in its block)."""
    n = len(tokens)
    if limit_tokens is not None:
        n = min(n, max(0, int(limit_tokens)))
    out: List[Tuple[int, Tuple[int, ...]]] = []
    h = _HASH_ROOT
    for i in range(n // block_size):
        chunk = tuple(int(t) for t in tokens[i * block_size : (i + 1) * block_size])
        h = hash((h, chunk))
        out.append((h, chunk))
    return out


class CacheOOM(Exception):
    """Not enough free blocks to admit the sequence right now."""

    def __init__(self, needed: int, free: int) -> None:
        super().__init__(f"kv cache exhausted: need {needed} blocks, {free} free")
        self.needed = needed
        self.free = free


class BlockAllocator:
    """Thread-safe ref-counted allocator over physical block ids
    ``1..num_blocks-1`` with an optional prefix cache.

    LIFO reuse on purpose: a just-freed block is handed out next, so the
    hot working set of physical blocks stays small and resident
    in whatever cache hierarchy backs HBM reads.  Cached (refcount-0 but
    matchable) blocks are only consumed once the free list is empty, so
    prefix reuse never fights short-lived allocations for block ids.
    """

    def __init__(
        self, num_blocks: int, block_size: int, prefix_cache: bool = False
    ) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is scratch), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache = bool(prefix_cache)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        #: live blocks -> reference count (shared prefix blocks count > 1)
        self._ref: Dict[int, int] = {}
        #: refcount-0 blocks still holding registered prefix content;
        #: insertion order is release order, so popping from the front
        #: evicts least-recently-released first (LRU)
        self._cached: "OrderedDict[int, int]" = OrderedDict()  # block -> hash
        #: the trie: chain hash -> physical block (live or cached)
        self._prefix: Dict[int, int] = {}
        #: reverse map for eviction/unregistration
        self._block_hash: Dict[int, int] = {}
        self.peak_in_use = 0
        # -- prefix counters (ride heartbeat stats) ---------------------------
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.evictions = 0

    # -- sizing --------------------------------------------------------------

    @property
    def capacity(self) -> int:
        """Usable blocks (excludes the scratch block)."""
        return self.num_blocks - 1

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for_tokens(n_tokens, self.block_size)

    # -- alloc / free --------------------------------------------------------

    def _evict_one_locked(self) -> int:
        """Reclaim the least-recently-released cached block.  Only ever
        touches refcount-0 blocks — live blocks are not in ``_cached``."""
        block, h = self._cached.popitem(last=False)
        assert block not in self._ref, "cached block has live references"
        self._prefix.pop(h, None)
        self._block_hash.pop(block, None)
        self.evictions += 1
        return block

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` private blocks (refcount 1 each) or raise
        :class:`CacheOOM` taking none.  Under pressure, refcount-0 cached
        prefix blocks are evicted LRU-first to satisfy the request."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        with self._lock:
            if n > len(self._free) + len(self._cached):
                raise CacheOOM(n, len(self._free) + len(self._cached))
            blocks: List[int] = []
            for _ in range(n):
                if self._free:
                    blocks.append(self._free.pop())
                else:
                    blocks.append(self._evict_one_locked())
            for b in blocks:
                self._ref[b] = 1
            self.peak_in_use = max(self.peak_in_use, len(self._ref))
            return blocks

    def share(self, blocks: Sequence[int]) -> None:
        """Add one reference to each (already live) block — the caller now
        co-owns them and must ``free`` them exactly once."""
        with self._lock:
            for b in blocks:
                if b not in self._ref:
                    raise ValueError(f"share of unallocated block {b}")
            for b in blocks:
                self._ref[b] += 1

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; a block whose count hits zero
        returns to the pool (or parks in the prefix cache if registered).
        Over-freeing — more frees than references — and foreign ids are
        programming errors and raise (a silently recycled block would
        corrupt another sequence's cache)."""
        with self._lock:
            for b in blocks:
                if b not in self._ref:
                    raise ValueError(f"free of unallocated block {b}")
            for b in blocks:
                self._ref[b] -= 1
                if self._ref[b] > 0:
                    continue
                del self._ref[b]
                h = self._block_hash.get(b)
                if self.prefix_cache and h is not None and self._prefix.get(h) == b:
                    # still the canonical block for its prefix hash: keep it
                    # resident and matchable until eviction wants it back
                    self._cached[b] = h
                    self._cached.move_to_end(b)
                else:
                    if h is not None:
                        self._block_hash.pop(b, None)
                    self._free.append(b)

    # -- prefix cache --------------------------------------------------------

    def match_prefix(
        self, chain: Sequence[Tuple[int, Tuple[int, ...]]]
    ) -> List[int]:
        """Walk ``chain`` (from :func:`prefix_block_hashes`) through the
        trie and take a reference on every block of the longest cached
        run.  Returns the physical blocks, root-first; the caller owns one
        reference per block and releases it via ``free`` at retirement."""
        with self._lock:
            self.prefix_lookups += 1
            matched: List[int] = []
            for h, _chunk in chain:
                b = self._prefix.get(h)
                if b is None:
                    break
                matched.append(b)
            for b in matched:
                if b in self._cached:
                    del self._cached[b]
                    self._ref[b] = 1
                else:
                    self._ref[b] += 1
            if matched:
                self.prefix_hits += 1
                self.prefix_tokens_saved += len(matched) * self.block_size
            self.peak_in_use = max(self.peak_in_use, len(self._ref))
            return matched

    def register_prefix(
        self,
        chain: Sequence[Tuple[int, Tuple[int, ...]]],
        blocks: Sequence[int],
    ) -> None:
        """Record ``blocks[i]`` as the canonical holder of ``chain[i]``'s
        content.  First writer wins: a hash already in the trie keeps its
        existing block (both hold identical content — content addressing
        makes the duplicate harmless, dedup only matters for future
        matches).  Blocks must be live (ref >= 1)."""
        if not self.prefix_cache:
            return
        with self._lock:
            for (h, _chunk), b in zip(chain, blocks):
                if h in self._prefix:
                    continue
                if b not in self._ref or b in self._block_hash:
                    continue
                self._prefix[h] = b
                self._block_hash[b] = h

    # -- inspection ----------------------------------------------------------

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Distinct live blocks — a block shared by N sequences counts ONCE
        (the router's load signal must not be inflated by sharing)."""
        with self._lock:
            return len(self._ref)

    @property
    def cached_blocks(self) -> int:
        """Refcount-0 blocks parked in the prefix cache (reclaimable)."""
        with self._lock:
            return len(self._cached)

    def utilization(self) -> float:
        """Live-block fraction of capacity; cached-but-reclaimable blocks
        do not count (they yield to any allocation)."""
        with self._lock:
            return len(self._ref) / max(1, self.capacity)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "used": len(self._ref),
                "free": len(self._free),
                "cached": len(self._cached),
                "peak": self.peak_in_use,
                "block_size": self.block_size,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "evictions": self.evictions,
            }
