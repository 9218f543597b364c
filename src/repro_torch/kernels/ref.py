"""Plain PyTorch versions of the port's six kernels.

Ports of the oracles of ``repro.kernels.ref``: ``attention_ref``,
``decode_attention_ref``, ``paged_decode_attention_ref``,
``chunked_prefill_attention_ref``, ``ragged_chunked_prefill_ref`` and
``rms_norm_ref``.  The paged ones gather each sequence's logical view
through its block table; every attention is one masked softmax in float32.
Two deliberate differences from the reference oracles, both of which make
the plain version compute exactly what the CUDA kernels compute:

  * probabilities are re-masked after the max shift and the sum is
    clamped at 1e-30, so a row with nothing to attend (``seq_len == 0``,
    a ``chunk_len == 0`` padding chunk with no prefix, an all-false
    decode mask row) returns zeros instead of the reference oracle's
    uniform average over masked keys;
  * the ragged prefill scatters the chunk K/V IN PLACE into the page
    pools (the reference returns new pools).  Padding rows
    (``t >= chunk_len``) are dropped by masking, never written.

The kernel wrappers call these for CPU tensors; the tests hold them
against the Pallas kernels in interpret mode, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card.
"""

from __future__ import annotations

from typing import Optional

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


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None):
    """q (B, Sq, H, D); k/v (B, Sk, KV, D) -> (B, Sq, H, D), positions
    aligned (query i and key i at position i).  Key j is attended by
    query i iff ``j <= i`` when ``causal`` and ``i - j < window`` when a
    window is given."""
    Sq, Sk = q.shape[1], k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    return _masked_attention(q, k, v, mask.expand(q.shape[0], Sq, Sk))


def decode_attention_ref(q, k_cache, v_cache, mask):
    """q (B, H, D); caches (B, S, KV, D); mask (B, S) bool -> (B, H, D).
    Row b attends slot s iff ``mask[b, s]``; a row whose mask is all false
    returns zeros."""
    if tuple(mask.shape) != (q.shape[0], k_cache.shape[1]):
        raise ValueError(f"mask {tuple(mask.shape)}, expected "
                         f"{(q.shape[0], k_cache.shape[1])}")
    return _masked_attention(q[:, None], k_cache, v_cache,
                             mask[:, None, :])[:, 0]


def decode_split_partials(q, k_cache, v_cache, mask, n_splits: int,
                          tile: int = 64):
    """The first pass of the split-K flash-decode kernel, in plain
    PyTorch (a model of its arithmetic for the tests; no caller on the
    card path).  Each cache row is cut into ``n_splits`` ranges of
    ``ceil(ceil(S / tile) / n_splits) * tile`` slots; range ``i`` gives
    float32 ``m`` (the max valid score, ``NEG_INF`` if none), ``l`` (the
    sum of ``exp(s - m)`` over its valid slots) and ``acc`` (those
    weights times the values).  A range with no valid slot, or none at
    all, gives ``m = NEG_INF``, ``l = 0``, ``acc = 0``.  Returns
    ``m, l`` (B, H, n_splits) and ``acc`` (B, H, n_splits, D).  The
    kernel works in base 2 (scores times log2 e), the same weights."""
    B, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    kf = torch.repeat_interleave(k_cache.float(), G, dim=2)   # (B, S, H, D)
    vf = torch.repeat_interleave(v_cache.float(), G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf) / (D ** 0.5)
    valid = mask[:, None, :].expand(B, H, S)
    s = torch.where(valid, s, NEG_INF)
    per = -(-max(1, -(-S // tile)) // n_splits) * tile
    ms, ls, accs = [], [], []
    for i in range(n_splits):
        lo, hi = min(S, i * per), min(S, (i + 1) * per)
        si, vi = s[..., lo:hi], valid[..., lo:hi]
        m = (si.amax(dim=-1) if hi > lo
             else torch.full((B, H), NEG_INF, device=q.device))
        p = torch.where(vi, torch.exp(si - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhs,bshd->bhd", p, vf[:, lo:hi]))
    return (torch.stack(ms, dim=-1), torch.stack(ls, dim=-1),
            torch.stack(accs, dim=-2))


def paged_decode_split_partials(q, k_pages, v_pages, block_tables, seq_lens,
                                n_splits: int, tile: int = 64):
    """The first pass of the split-K paged decode kernel, in plain
    PyTorch (a model of its arithmetic for the tests; no caller on the
    card path): ``decode_split_partials`` over each sequence's ``nb * bs``
    logical positions, position ``p`` being row ``p % bs`` of page
    ``block_tables[b, p // bs]``, attended iff ``p < seq_lens[b]``.  As
    in the kernel, a position past ``seq_len`` never indexes the pools,
    so table entries past a sequence's live pages may hold anything.  A
    range wholly past ``seq_len`` gives the empty partial (``m =
    NEG_INF``, ``l = 0``, ``acc = 0``)."""
    N, bs = k_pages.shape[:2]
    L = block_tables.shape[1] * bs
    pos = torch.arange(L, device=q.device)
    live = pos[None, :] < seq_lens.long()[:, None]                # (B, L)
    rows = torch.where(live, block_tables.long()[:, pos // bs] * bs
                       + pos % bs, 0)
    feat = tuple(k_pages.shape[2:])
    k = k_pages.reshape((N * bs,) + feat)[rows]                   # (B, L, ...)
    v = v_pages.reshape((N * bs,) + feat)[rows]
    return decode_split_partials(q, k, v, live, n_splits, tile=tile)


def combine_split_partials(m, l, acc, dtype=torch.float32):
    """The split-K kernel's second pass: ``M = max_i m_i``, ``L = sum_i
    l_i e^(m_i - M)``, ``out = sum_i acc_i e^(m_i - M) / max(L, 1e-30)``,
    cast to ``dtype``.  A row whose every range is empty (``l = 0``,
    ``acc = 0``) comes out exactly zero."""
    M = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - M)
    L = (l * w).sum(dim=-1)
    out = (acc * w[..., None]).sum(dim=-2)
    return (out / torch.clamp(L, min=1e-30)[..., None]).to(dtype)


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


def chunked_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                  ctx_lens):
    """q (B, T, H, D); pages (N, bs, KV, D) already holding each row's
    chunk K/V at logical positions ``ctx_lens[b] .. ctx_lens[b] + T - 1``;
    block_tables (B, nb) i32; ctx_lens (B,) i32 -> (B, T, H, D).  Query t
    attends positions ``<= ctx_lens[b] + t``: full over the prefix, causal
    within the chunk."""
    k = _gather(k_pages, block_tables)
    v = _gather(v_pages, block_tables)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    t = torch.arange(q.shape[1], device=q.device)
    mask = (kv_pos[None, None, :]
            <= ctx_lens.long()[:, None, None] + t[None, :, None])
    return _masked_attention(q, k, v, mask)


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


def rms_norm_ref(x, weight, eps: float = 1e-6):
    """x (..., D); weight (D,) -> ``x * rsqrt(mean(x^2) + eps) * (1 + w)``
    reduced and scaled in float32, cast to x's dtype (as
    ``models.layers.rms_norm``)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)
