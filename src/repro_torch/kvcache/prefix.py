"""Copy-on-write prefix caching over the paged KV pool (a copy of
``repro.kvcache.prefix``).

Written prompt blocks are indexed by a content-hash chain so that later
sequences whose padded prompt bucket starts with the same tokens share
those physical blocks read-only.  Host-side and framework-free: the
port's engine (``ServingEngine(prefix_cache=True)``) and the reference
simulator (``simulate_continuous(prefix_cache=True)``) drive the same
class, so hit / CoW / eviction counters are comparable bit for bit.

  * ``block_hashes(tokens, block_size)`` — one chained FNV-1a hash per
    FULL block; a hit also needs a verbatim token match, so a hash
    collision degrades to a miss.
  * ``PrefixCache.admit`` — longest cached-prefix lookup: shares matched
    blocks (refcounted), allocates private blocks for the rest, and
    returns the first position the caller's prefill must compute plus
    the copy-on-write page copies it owes (a full-prompt match
    recomputes its last position, a divergent write into the last
    shared block; the engine copies the page with
    ``transformer.copy_paged_block``).
  * ``PrefixCache.commit`` — after the prefill lands, indexes the
    sequence's fresh full blocks (the cache pins each with one
    reference).
  * ``PrefixCache.evict_lru`` — the allocator's ``reclaim`` hook: under
    pool pressure, cached blocks nobody else references are evicted
    oldest first.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

from .allocator import BlockAllocator, blocks_for_tokens

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv(h: int, v: int) -> int:
    return ((h ^ v) * _FNV_PRIME) & _MASK


def block_hashes(tokens: Sequence[int], block_size: int) -> List[int]:
    """One chained FNV-1a hash per FULL block of ``tokens``.

    ``h[i]`` folds in every token of blocks ``0..i``, so two prompts
    share ``h[i]`` iff their first ``(i+1) * block_size`` tokens match
    (modulo hash collision) — the longest-cached-prefix walk is a plain
    front-to-back dictionary probe.  The trailing partial block (and
    everything a prompt shorter than one block) is never hashed: only
    fully written, immutable-content blocks are shareable.
    """
    out: List[int] = []
    h = _FNV_OFFSET
    for i in range(len(tokens) // block_size):
        for t in tokens[i * block_size:(i + 1) * block_size]:
            h = _fnv(h, int(t))
        out.append(h)
    return out


@dataclasses.dataclass
class PrefixAdmit:
    """What ``PrefixCache.admit`` decided for one admission."""

    start: int                       # first prompt position to compute
    matched_blocks: int              # full blocks reused from the cache
    cow: List[Tuple[int, int]]       # (src, dst) device page copies owed


class PrefixCache:
    """Content-hash index of written prompt blocks, LRU-evicted.

    Owns no device state: it drives a ``BlockAllocator`` (share /
    allocate / cow_block / drop_ref) and an insertion-ordered
    ``hash -> physical block`` map whose order IS the LRU order
    (entries are re-appended on every hit).  Cached block ids index ONE
    device page pool: by default the engine builds a fresh instance per
    ``serve()`` alongside a fresh pool, but with
    ``ServingEngine(persist_prefix_cache=True)`` the pool, allocator
    and this index survive across serves (repeat traffic hits warm) —
    the engine then calls ``reset_stats()`` at each serve start so the
    counters stay per-serve while the index persists.
    """

    def __init__(self, allocator: BlockAllocator, block_size: int):
        if block_size != allocator.block_size:
            raise ValueError(
                f"block_size {block_size} != allocator's "
                f"{allocator.block_size}")
        self.alloc = allocator
        self.block_size = block_size
        # hash -> (physical block, the block's own token ids).  The
        # token ids guard against chain-hash collisions: a hit is only
        # honored when the probed block's tokens match verbatim — and
        # since the walk is front-to-back, per-block verification
        # inductively verifies the whole prefix (FNV-1a is fast, not
        # collision-proof; a silent collision would violate the
        # token-for-token output invariant).
        self._entries: "OrderedDict[int, Tuple[int, Tuple[int, ...]]]" \
            = OrderedDict()
        # pressure valve: allocator pops cached refcount-1 blocks LRU
        # first when its free list runs dry
        allocator.reclaim = self.evict_lru
        # shared counter definitions — ServingEngine._result and
        # SimResult read these verbatim, so engine-vs-sim parity on the
        # hit/CoW/eviction numbers is equality of these fields
        self.lookup_blocks = 0           # full blocks probed
        self.hit_blocks = 0              # probes that hit
        self.tokens_reused = 0           # prompt tokens NOT recomputed
        self.cow_copies = 0
        self.evictions = 0
        # optional repro.obs MetricsRegistry: when set (the serve loops
        # assign it at serve start), the same counters also stream into
        # the shared registry under "prefix.*" — deterministic
        # quantities, so they stay engine-vs-sim parity-comparable
        self.metrics = None

    def reset_stats(self) -> None:
        """Zero the per-serve counters WITHOUT touching the index or
        its block references (persistent-cache serve start: metrics are
        per serve, cached content carries over)."""
        self.lookup_blocks = 0
        self.hit_blocks = 0
        self.tokens_reused = 0
        self.cow_copies = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    @property
    def num_cached_blocks(self) -> int:
        return len(self._entries)

    def hit_rate(self) -> float:
        return (self.hit_blocks / self.lookup_blocks
                if self.lookup_blocks else 0.0)

    def stats(self) -> Dict:
        return {
            "prefix_hit_rate": self.hit_rate(),
            "cached_tokens_reused": self.tokens_reused,
            "cow_copies": self.cow_copies,
            "prefix_evictions": self.evictions,
            "cached_blocks": len(self._entries),
        }

    # ------------------------------------------------------------------
    def admit(self, seq_id: int, tokens: Sequence[int]) -> PrefixAdmit:
        """Admission-side half: match, share, CoW, allocate the rest.

        After this returns, ``alloc.table(seq_id)`` holds the prompt's
        full ``blocks_for(len(tokens))`` table — matched shared blocks
        first (in prefix order), then fresh private blocks — and the
        caller must (a) perform the returned ``cow`` device page
        copies, then (b) prefill positions ``start ..`` only.
        """
        S = len(tokens)
        bs = self.block_size
        hashes = block_hashes(tokens, bs)
        self.lookup_blocks += len(hashes)
        matched: List[int] = []
        for i, h in enumerate(hashes):
            entry = self._entries.get(h)
            if entry is None:
                break
            blk, blk_tokens = entry
            if tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]) \
                    != blk_tokens:
                break                      # hash collision: treat as miss
            self._entries.move_to_end(h)
            matched.append(blk)
        self.hit_blocks += len(matched)
        if self.metrics is not None:
            self.metrics.counter("prefix.lookup_blocks").inc(len(hashes))
            self.metrics.counter("prefix.hit_blocks").inc(len(matched))
        # share FIRST: the sequence's references pin the matched blocks
        # against the LRU reclaim the allocations below may trigger
        for blk in matched:
            self.alloc.share(seq_id, blk)
        start = len(matched) * self.block_size
        cow: List[Tuple[int, int]] = []
        if matched and start == S:
            # full-prompt match: every KV entry is cached, but the
            # sampler still needs the LAST position's logits, so
            # position S-1 is recomputed — a (numerically identical)
            # write into the last shared block, i.e. the divergent
            # write that triggers copy-on-write.
            start = S - 1
            cow.append(self.alloc.cow_block(seq_id, len(matched) - 1))
            self.cow_copies += 1
            if self.metrics is not None:
                self.metrics.counter("prefix.cow_copies").inc()
        self.tokens_reused += start
        need = blocks_for_tokens(S, self.block_size) \
            - len(self.alloc.table(seq_id))
        if need > 0:
            self.alloc.allocate_n(seq_id, need)
        return PrefixAdmit(start=start, matched_blocks=len(matched),
                           cow=cow)

    def commit(self, seq_id: int, tokens: Sequence[int]) -> int:
        """Completion-side half: index the freshly written full blocks.

        Runs when the sequence's prefill completes (synchronously for
        stall admission, on the final chunk for chunked prefill).  A
        hash another sequence registered in the meantime is only
        touched (LRU refresh) — the duplicate private block stays
        unindexed and is freed with its owner.  Returns the number of
        newly indexed blocks.
        """
        table = self.alloc.table(seq_id)
        bs = self.block_size
        added = 0
        for i, h in enumerate(block_hashes(tokens, bs)):
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            self.alloc.add_ref(table[i])     # the cache's own pin
            self._entries[h] = (
                table[i], tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
            added += 1
        return added

    # ------------------------------------------------------------------
    def evict_lru(self) -> bool:
        """Free ONE cached block no sequence references (LRU first).

        Installed as the allocator's ``reclaim`` hook, so eviction
        happens exactly under pool pressure and never touches a block
        whose refcount exceeds the cache's own pin.  Evicting a chain
        interior leaves deeper entries unreachable for matching; they
        age out and are evicted by the same rule.
        """
        victim = None
        for h, (blk, _) in self._entries.items():  # oldest first
            if self.alloc.refcount(blk) == 1:
                victim = h
                break
        if victim is None:
            return False
        self.alloc.drop_ref(self._entries.pop(victim)[0])
        self.evictions += 1
        if self.metrics is not None:
            self.metrics.counter("prefix.evictions").inc()
        return True

    def clear(self) -> int:
        """Drop every cache reference (tests / end-of-serve leak
        checks); blocks referenced only by the cache return to the
        free list.  Returns the number of entries dropped."""
        n = len(self._entries)
        for blk, _ in self._entries.values():
            self.alloc.drop_ref(blk)
        self._entries.clear()
        self.alloc.reclaim = None
        return n
