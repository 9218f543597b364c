"""Plain PyTorch oracles of the two ported attention kernels.

Port of the two paged oracles of ``repro.kernels.ref``
(``paged_decode_attention_ref``, ``ragged_chunked_prefill_ref``): gather
each sequence's logical view through its block table, then a masked
softmax in float32.  Two deliberate differences from the reference
oracles, both of which make the plain version compute exactly what the
kernels (TPU and CUDA alike) compute:

  * probabilities are re-masked after the max shift and the sum is
    clamped at 1e-30, so a row with nothing to attend (``seq_len == 0``,
    or a ``chunk_len == 0`` padding chunk with no prefix) returns zeros
    instead of the reference oracle's uniform average over masked keys;
  * the ragged prefill scatters the chunk K/V IN PLACE into the page
    pools (the reference returns new pools).  Padding rows
    (``t >= chunk_len``) are dropped by masking, never written.

The kernel wrappers (``paged_decode_attention.py``,
``ragged_chunked_prefill.py``) call these for CPU tensors; the tests hold
them against the Pallas kernels in interpret mode, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """pages (N, bs, KV, D); tables (B, nb) -> (B, nb*bs, KV, D)."""
    N, bs = pages.shape[:2]
    B, nb = tables.shape
    idx = (tables.long()[:, :, None] * bs
           + torch.arange(bs, device=pages.device)[None, None, :])
    flat = pages.reshape((N * bs,) + tuple(pages.shape[2:]))
    return flat[idx.reshape(B, nb * bs)]


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, L, KV, D); mask (B, Sq, L) bool.
    Float32 softmax with the kernels' empty-row rule; returns
    (B, Sq, H, D) in q's dtype."""
    H, D = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    kf = torch.repeat_interleave(k.float(), G, dim=2)
    vf = torch.repeat_interleave(v.float(), G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (D ** 0.5)
    m4 = mask[:, None, :, :]
    s = torch.where(m4, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m4, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.clamp(l, min=1e-30), vf)
    return out.to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens):
    """q (B, H, D); pages (N, bs, KV, D); block_tables (B, nb) i32;
    seq_lens (B,) i32 -> (B, H, D).  Key position p of row b is attended
    iff p < seq_lens[b]; a ``seq_len == 0`` row returns zeros."""
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    L = k.shape[1]
    mask = (torch.arange(L, device=q.device)[None, :]
            < seq_lens.long()[:, None])                       # (B, L)
    return _masked_attention(q[:, None], k, v, mask[:, None, :])[:, 0]


def ragged_chunked_prefill_ref(q, k_new, v_new, k_pages, v_pages,
                               block_tables, meta):
    """q (C, T, H, D); k_new/v_new (C, T, KV, D) in the page dtype; pages
    (N, bs, KV, D), updated in place; block_tables (C, nb) i32; meta
    (C, 4) i32 rows ``[slot, ctx_len, chunk_len, q_offset]``.

    Writes chunk c's rows ``t < chunk_len`` at logical positions
    ``ctx_len + t`` (block index clamped to the table width, as the
    reference oracle's gather clamps), then query row t attends over
    positions ``< ctx_len`` plus the chunk's own rows ``t_kv <= t`` with
    ``t_kv < chunk_len``.  Returns out (C, T, H, D); rows
    ``t >= chunk_len`` are padding."""
    C, T = q.shape[:2]
    N, bs = k_pages.shape[:2]
    nb = block_tables.shape[1]
    ctx = meta[:, 1].long()
    lens = meta[:, 2].long()
    t = torch.arange(T, device=q.device)
    pos = ctx[:, None] + t[None, :]                               # (C, T)
    blk = torch.gather(block_tables.long(), 1,
                       torch.clamp(pos // bs, max=nb - 1))
    flat = (blk * bs + pos % bs).reshape(-1)
    valid = (t[None, :] < lens[:, None]).reshape(-1)
    feat = tuple(k_pages.shape[2:])
    rows = valid.nonzero()[:, 0]
    k_pages.view((N * bs,) + feat)[flat[rows]] = (
        k_new.reshape((C * T,) + feat)[rows].to(k_pages.dtype))
    v_pages.view((N * bs,) + feat)[flat[rows]] = (
        v_new.reshape((C * T,) + feat)[rows].to(v_pages.dtype))
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    # prefix positions < ctx, then the chunk's own causal rows
    in_chunk = kv_pos[None, None, :] - ctx[:, None, None]        # (C, 1, L)
    mask = ((kv_pos[None, None, :] < ctx[:, None, None])
            | ((in_chunk >= 0) & (in_chunk <= t[None, :, None])
               & (in_chunk < lens[:, None, None])))
    return _masked_attention(q, k, v, mask)
