"""Device-side paged K/V store: gather/scatter primitives + container.

PyTorch port of ``repro.kvcache.paged``.  Pages are tensors of shape
``(num_blocks, block_size, *feat)``; a sequence's token at logical
position ``p`` lives in physical block ``table[p // bs]`` at row
``p % bs`` (the vLLM block-table layout).

The scatters write IN PLACE (the reference returns new arrays).  JAX clamps
out-of-range gather indices and drops out-of-range scatter rows silently;
a torch index out of range raises instead, so every clamp the reference
relies on is written out here: the block lookup clamps ``pos // bs`` to the
table width (dead decode rows with a stale, growing ``pos`` land on the
trash page), and ``scatter_packed`` drops invalid rows by masking them out
of the write, never by writing to a row past the pool.  Rows of several
dead sequences may all land on the trash page; those duplicate writes are
expected and harmless.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .allocator import blocks_for_tokens


def _flat(pages: torch.Tensor) -> torch.Tensor:
    """(N, bs, *feat) -> (N*bs, *feat) token-major view (shares storage)."""
    N, bs = pages.shape[:2]
    return pages.view((N * bs,) + tuple(pages.shape[2:]))


def gather_tokens(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pages (N, bs, *feat); tables (B, nb) -> (B, nb*bs, *feat), each
    row's logical positions 0..nb*bs-1 (entries past a sequence's length
    hold whatever the page holds; callers mask by length)."""
    bs = pages.shape[1]
    B, nb = tables.shape
    idx = (tables.long()[:, :, None] * bs
           + torch.arange(bs, device=tables.device)[None, None, :])
    return _flat(pages)[idx.reshape(B, nb * bs)]


def _block_of(tables_rows: torch.Tensor, pos: torch.Tensor,
              bs: int) -> torch.Tensor:
    """Physical block of logical ``pos`` with the reference's clamp of
    the table index to the table width."""
    nb = tables_rows.shape[-1]
    blk_idx = torch.clamp(torch.div(pos, bs, rounding_mode="floor"),
                          max=nb - 1)
    return torch.gather(tables_rows.long(), -1, blk_idx.long())


def scatter_token(pages: torch.Tensor, values: torch.Tensor,
                  tables: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one token per sequence at its logical position, in place.

    pages (N, bs, *feat); values (B, *feat); tables (B, nb); pos (B,)."""
    bs = pages.shape[1]
    pos = pos.long()
    blk = _block_of(tables, pos[:, None], bs)[:, 0]
    _flat(pages)[blk * bs + pos % bs] = values.to(pages.dtype)


def scatter_chunk(pages: torch.Tensor, seq: torch.Tensor,
                  table_row: torch.Tensor, start) -> None:
    """Write one sequence's chunk (T, *feat) at logical positions
    ``start .. start + T - 1``, in place."""
    bs = pages.shape[1]
    T = seq.shape[0]
    pos = torch.as_tensor(start, device=seq.device).long() + torch.arange(
        T, device=seq.device)
    blk = _block_of(table_row, pos, bs)
    _flat(pages)[blk * bs + pos % bs] = seq.to(pages.dtype)


def scatter_packed(pages: torch.Tensor, seq: torch.Tensor,
                   tables: torch.Tensor, token_chunk: torch.Tensor,
                   positions: torch.Tensor, valid: torch.Tensor) -> None:
    """Write a PACKED multi-chunk K/V stream (TT, *feat) in place.

    Row ``j`` belongs to chunk ``token_chunk[j]`` at logical position
    ``positions[j]``; rows with ``valid[j]`` False (padding) are dropped by
    masking them out of the write, never written."""
    bs = pages.shape[1]
    positions = positions.long()
    blk = _block_of(tables[token_chunk.long()], positions[:, None], bs)[:, 0]
    flat_idx = blk * bs + positions % bs
    _flat(pages)[flat_idx[valid]] = seq[valid].to(pages.dtype)


def as_index(i, device) -> torch.Tensor:
    """A (1,) int64 index on ``device`` from an int, or from a 0-d or
    1-element int tensor, which stays on its device: an index the engine
    hands a CUDA graph is read by the graph's kernels, never by the host
    (``int()`` of a device tensor synchronises, which a capture
    forbids)."""
    if isinstance(i, torch.Tensor):
        return i.reshape(1).long()
    return torch.full((1,), int(i), dtype=torch.long, device=device)


def copy_block(pages: torch.Tensor, src, dst) -> None:
    """Copy one physical page in place: ``pages[dst] = pages[src]`` (the
    prefix cache's copy-on-write of a fully matched prompt's last
    block).  ``src``/``dst``: ints or 1-element int tensors
    (``as_index``)."""
    src, dst = (as_index(b, pages.device) for b in (src, dst))
    pages.index_copy_(0, dst, pages.index_select(0, src))


def scatter_prefill(pages: torch.Tensor, seq: torch.Tensor,
                    table_row: torch.Tensor, seq_len: int) -> None:
    """Write a freshly prefilled sequence into its table's blocks, in place.

    seq (S, *feat) with S >= seq_len (the prefill ring's leading rows;
    only the first ``seq_len`` are written); table_row (nb,) backs
    positions ``0 .. seq_len - 1``."""
    bs = pages.shape[1]
    pos = torch.arange(seq_len, device=seq.device)
    blk = table_row.long()[pos // bs]
    _flat(pages)[blk * bs + pos % bs] = seq[:seq_len].to(pages.dtype)


# ---------------------------------------------------------------------------
# container
# ---------------------------------------------------------------------------


class PagedKVCache:
    """Paged KV store for the continuous engine.

    Owns the device-side state (per-layer K/V page pools plus per-slot
    ``pos``, built by ``transformer.init_paged_cache``; both are updated in
    place by the model; on the card also the RoPE table over a whole
    block table's positions) and the host-side ``(num_slots,
    max_blocks_per_seq)`` numpy block-table array.  One extra physical
    page, ``trash_block`` (= ``num_blocks``), is never handed out by the
    allocator: evicted (dead) decode rows keep stepping and their tables
    point there.
    ``device=None`` means the card and raises when none is present.
    """

    def __init__(self, cfg, num_slots: int, num_blocks: int,
                 block_size: int, max_len: int, dtype=torch.bfloat16,
                 device=None):
        from ..models import transformer  # lazy: avoid import cycle
        self.num_slots = num_slots
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_len = max_len
        self.max_blocks_per_seq = blocks_for_tokens(max_len, block_size)
        self.trash_block = num_blocks
        self.state = transformer.init_paged_cache(
            cfg, num_slots, num_blocks + 1, block_size, dtype,
            resolve_device(device),
            rope_len=self.max_blocks_per_seq * block_size)
        self.device = self.state["pos"].device
        self.tables = np.full((num_slots, self.max_blocks_per_seq),
                              self.trash_block, np.int32)

    # -- table management (host) ---------------------------------------
    def set_table(self, slot: int, blocks) -> None:
        """Install a freshly admitted sequence's table into ``slot``."""
        row = np.full((self.max_blocks_per_seq,), self.trash_block,
                      np.int32)
        row[:len(blocks)] = blocks
        self.tables[slot] = row

    def extend_table(self, slot: int, block_index: int, block: int) -> None:
        """Record a boundary-crossing allocation for ``slot``."""
        self.tables[slot, block_index] = block

    def clear_table(self, slot: int) -> None:
        """Point an evicted slot back at the trash page."""
        self.tables[slot] = self.trash_block

    def tables_device(self) -> torch.Tensor:
        return torch.from_numpy(self.tables.copy()).to(self.device)

    def table_row(self, slot: int) -> torch.Tensor:
        return torch.from_numpy(self.tables[slot].copy()).to(self.device)


def default_num_blocks(num_slots: int, max_len: int,
                       block_size: int) -> int:
    """Block count matching a contiguous ``(num_slots, max_len)`` slot
    cache's KV-token budget (the equal-budget comparison)."""
    return max(1, num_slots * max_len // block_size)
