"""Host-side block allocator: free list + per-sequence block tables
+ per-block reference counts.

The allocator is deliberately dumb and exact — a list of free physical
block ids, a ``seq_id -> [block ids]`` table map and a ``block ->
refcount`` map.  All policy (reservation-based admission, lazy
boundary-crossing allocation, prefix matching) lives in the serving
engine / simulator / ``kvcache.prefix``; the allocator only enforces
the hard invariants the property tests pin down:

  * a live block is never handed out twice: ``allocate`` only pops
    blocks no one references;
  * reference counts balance: every ``share``/``add_ref`` is undone by
    exactly one ``free_sequence`` entry / ``drop_ref``, and a block
    returns to the free list exactly when its count reaches zero — so
    no block shared by a prefix cache or a sibling sequence is ever
    freed while someone still reads it;
  * ``free_sequence`` drops one reference per table entry (no leaks —
    after a full ``serve()`` plus a cache ``clear()`` the pool is
    whole again).

Copy-on-write lives here as ``cow_block``: replacing one SHARED entry
of a sequence's table with a fresh private block (the caller copies the
device-side page contents).  The sharing machinery is only engaged by
``kvcache.prefix.PrefixCache``; plain paged serving keeps every block
at refcount 1 and behaves exactly as before.

Under allocator pressure an optional ``reclaim`` hook (installed by the
prefix cache) is consulted: it must release at least one block back to
the free list per call (LRU eviction of cached, otherwise-unreferenced
blocks) or return False, at which point ``OutOfBlocksError`` is raised.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple


def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
    """Memory formula: blocks needed to hold ``num_tokens`` KV entries.

    Shared by the engine's admission gate and the simulator's
    block-budget model — both must compute reservations identically or
    engine-vs-sim parity breaks.
    """
    if num_tokens <= 0:
        return 0
    return -(-num_tokens // block_size)


def window_target_tokens(prompt_len: int, produced: int, cap: int,
                         steps: int) -> int:
    """Tokens a slot's block table must cover before an N-step decode
    window (the multi-step launch of the async host pipeline).

    A slot that has ``produced`` tokens sits at write position
    ``prompt + produced - 1``; window step j (1-based) writes position
    ``prompt + produced + j - 2`` and emits token ``produced + j``.
    Readback — and therefore EOS/cap detection and eviction — happens
    only at window END (in arrears), so a sequence may be stepped up
    to ``steps - 1`` times past its logical end.  The LAST useful write
    is the one emitting token ``cap`` (position ``prompt + cap - 2``),
    which is why the target clamps at ``prompt + cap - 1``: overhang
    writes past the cap fall off the sequence's table onto the trash
    page (the scatter primitives clamp the block index to the table
    width), and post-EOS writes before the cap land in the slot's own
    still-held private blocks, freed untouched at window end.

    The clamp is the eviction-lag invariant: the target never exceeds
    the admission reservation ``blocks_for(prompt + cap - 1)``, so
    admission/rejection decisions are identical for every ``steps`` —
    the engine and the simulator both allocate against this formula.
    ``steps=1`` reduces exactly to the synchronous per-step rule
    ``prompt + produced`` (the pre-window state of the original loop).
    """
    return prompt_len + min(produced + steps, cap) - 1


class OutOfBlocksError(RuntimeError):
    """Raised when an allocation is requested from an empty free list.

    With reservation-based admission this is a bug, not backpressure:
    the engine reserves a sequence's worst case up front (and cached
    refcount-0 blocks are reclaimable on demand), so a boundary
    crossing must never find the pool empty.
    """


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` physical KV blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # popped from the end so blocks hand out in ascending id order
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}
        # optional pressure valve (kvcache.prefix installs LRU eviction
        # of cached blocks here); must free >= 1 block or return False
        self.reclaim: Optional[Callable[[], bool]] = None

    # -- accounting ----------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def live_sequences(self) -> int:
        return len(self._tables)

    def utilization(self) -> float:
        return self.num_used / self.num_blocks

    def blocks_for(self, num_tokens: int) -> int:
        return blocks_for_tokens(num_tokens, self.block_size)

    def refcount(self, block: int) -> int:
        """References held on ``block`` (0 = free)."""
        return self._refs.get(block, 0)

    # -- alloc / share / free ------------------------------------------
    def _ensure_free(self, n: int) -> None:
        """Make sure ``n`` blocks are on the free list, reclaiming
        cached blocks through the ``reclaim`` hook if one is installed."""
        while len(self._free) < n:
            if self.reclaim is None or not self.reclaim():
                raise OutOfBlocksError(
                    f"need {n} free KV blocks, have {len(self._free)} "
                    f"(of {self.num_blocks}) and nothing to reclaim")

    def allocate(self, seq_id: int) -> int:
        """Append one fresh (refcount-1) block to ``seq_id``'s table."""
        self._ensure_free(1)
        blk = self._free.pop()
        assert blk not in self._refs, f"block {blk} double-allocated"
        self._refs[blk] = 1
        self._tables.setdefault(seq_id, []).append(blk)
        return blk

    def allocate_n(self, seq_id: int, n: int) -> List[int]:
        self._ensure_free(n)
        return [self.allocate(seq_id) for _ in range(n)]

    def share(self, seq_id: int, block: int) -> None:
        """Append an already-live block to ``seq_id``'s table, taking
        one more reference (prefix-cache hit: the sequence READS the
        block; it must copy-on-write before any divergent write)."""
        assert block in self._refs, f"cannot share free block {block}"
        self._refs[block] += 1
        self._tables.setdefault(seq_id, []).append(block)

    def add_ref(self, block: int) -> None:
        """Take a table-less reference (the prefix cache pinning a
        block it indexes)."""
        assert block in self._refs, f"cannot reference free block {block}"
        self._refs[block] += 1

    def drop_ref(self, block: int) -> bool:
        """Release one reference; returns True when the block was freed
        (count reached zero and it went back on the free list)."""
        n = self._refs[block] - 1
        assert n >= 0
        if n == 0:
            del self._refs[block]
            self._free.append(block)
            return True
        self._refs[block] = n
        return False

    def cow_block(self, seq_id: int, index: int) -> Tuple[int, int]:
        """Copy-on-write: replace ``seq_id``'s SHARED table entry
        ``index`` with a fresh private block.  Returns ``(src, dst)``
        physical ids — the caller copies the device-side page contents
        of ``src`` into ``dst`` before writing.  The shared block keeps
        its remaining references (cache / sibling sequences), so a CoW
        never mutates a block someone else still reads.
        """
        table = self._tables[seq_id]
        src = table[index]
        assert self._refs[src] >= 2, (
            f"block {src} is private (refcount {self._refs[src]}); "
            "write in place instead of CoW")
        self._ensure_free(1)
        dst = self._free.pop()
        assert dst not in self._refs, f"block {dst} double-allocated"
        self._refs[dst] = 1
        table[index] = dst
        self.drop_ref(src)
        return src, dst

    def table(self, seq_id: int) -> List[int]:
        """The sequence's block table (copy), empty if unknown."""
        return list(self._tables.get(seq_id, ()))

    def free_sequence(self, seq_id: int) -> int:
        """Drop one reference per table entry of ``seq_id``; returns the
        number of entries released.  Blocks return to the pool only when
        their LAST reference drops — shared prefix blocks survive as
        long as the cache or a sibling sequence still holds them.

        Idempotent: freeing an unknown (or already-freed) sequence is a
        no-op — eviction paths need not track whether a sequence ever
        received blocks.
        """
        blocks = self._tables.pop(seq_id, None)
        if not blocks:
            return 0
        for blk in blocks:
            self.drop_ref(blk)
        return len(blocks)

    def free_all(self) -> int:
        """Crash-time bulk free: drop every live sequence in ascending
        seq-id order (deterministic free-list order on both sides of a
        parity run); returns the number of table entries released.
        Table-less references (prefix-cache pins) are untouched — the
        cache outlives a replica crash exactly like it outlives normal
        eviction."""
        released = 0
        for seq_id in sorted(self._tables):
            released += self.free_sequence(seq_id)
        return released

    def check_no_leaks(self) -> None:
        """Assert the pool is whole (used by tests after a full serve;
        prefix-cache engines ``clear()`` the cache's references first)."""
        assert not self._tables and not self._refs, (
            f"leaked {self.num_used} blocks across "
            f"{self.live_sequences} sequences "
            f"({len(self._refs)} referenced)")
        assert sorted(self._free) == list(range(self.num_blocks))
