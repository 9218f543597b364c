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


#: the prefill kernels' tiles (kTileKeys, kWarpRows and kCtaRows of
#: csrc/prefill_attn.cuh, which the tests hold these to): key positions of
#: a tile, t-major query rows of a warp tile, and of a CTA (4 warps)
PREFILL_TILE_KEYS = 64
PREFILL_WARP_ROWS = 16
PREFILL_CTA_ROWS = 4 * PREFILL_WARP_ROWS


def prefill_writer_tiles(T: int, G: int, cta_rows: int) -> torch.Tensor:
    """Which CTA of the fused ragged prefill stores each of a chunk's T
    tokens: the CTA of ``cta_rows`` t-major rows (row ``t * G + g``) that
    holds row ``t * G``, found as the kernel finds it (CTA ``i`` stores
    tokens ``ceil(i * cta_rows / G) <= t < ceil((i + 1) * cta_rows /
    G)``).  Returns (T,) CTA indices; a token no CTA would store is -1."""
    writer = torch.full((T,), -1, dtype=torch.long)
    for i in range(-(-T * G // cta_rows)):
        lo = -(-i * cta_rows // G)
        hi = min(T, -(-(i + 1) * cta_rows // G))
        writer[lo:hi] = i
    return writer


def _prefill_tiles(q, KV: int, t_live: int, last_key,
                   kv_rows) -> torch.Tensor:
    """One chunk of the prefill kernels' body (csrc/prefill_attn.cuh) in
    plain float32 PyTorch.  q (T, H, D); the query rows of KV group
    ``kvh`` in t-major order (row ``t * G + g`` is head ``kvh * G + g``
    at token t), cut into tiles of ``PREFILL_WARP_ROWS``; query t sees
    the positions ``p <= last_key(t)`` (a LongTensor of t in, of
    positions out).  A tile whose first row is at ``t >= t_live`` returns
    zeros and reads nothing.  A live tile walks the positions in tiles of
    ``PREFILL_TILE_KEYS`` up to
    what its last live row sees, with an online softmax; only the
    positions up to there are read, through ``kv_rows(p) -> (k, v)``
    ((n, KV, D) each), so nothing past them is ever indexed.  Returns
    (T, H, D) float32."""
    T, H, D = q.shape
    G = H // KV
    rows, tile = PREFILL_WARP_ROWS, PREFILL_TILE_KEYS
    n_rows = T * G
    live_rows = min(n_rows, t_live * G)
    scale = 1.0 / D ** 0.5
    qf = q.float().reshape(T, KV, G, D).transpose(0, 1).reshape(KV, n_rows,
                                                                 D)
    out = torch.zeros((KV, n_rows, D), dtype=torch.float32, device=q.device)
    for r0 in range(0, live_rows, rows):
        r1 = min(r0 + rows, n_rows)
        lim = last_key(torch.arange(r0, r1, device=q.device) // G)  # (R,)
        last = int(last_key(torch.tensor([(min(r1, live_rows) - 1) // G],
                                         device=q.device))[0])
        m = torch.full((KV, r1 - r0), float("-inf"), device=q.device)
        l = torch.zeros((KV, r1 - r0), device=q.device)
        acc = torch.zeros((KV, r1 - r0, D), device=q.device)
        for p0 in range(0, last + 1, tile):
            p = torch.arange(p0, p0 + tile, device=q.device)
            read = p <= last
            k = torch.zeros((tile, KV, D), device=q.device)
            v = torch.zeros((tile, KV, D), device=q.device)
            k[read], v[read] = (x.float() for x in kv_rows(p[read]))
            valid = (p[None, :] <= lim[:, None])[None]           # (1, R, n)
            s = torch.einsum("xrd,pxd->xrp", qf[:, r0:r1], k) * scale
            s = torch.where(valid, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_use = torch.where(torch.isinf(m_new), 0.0, m_new)
            w = torch.where(valid, torch.exp(s - m_use[..., None]), 0.0)
            corr = torch.exp(m - m_use)
            l = l * corr + w.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("xrp,pxd->xrd", w, v)
            m = m_new
        out[:, r0:r1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(KV, T, G, D).transpose(0, 1).reshape(T, H, D)


def ragged_prefill_tiles(q, k_new, v_new, k_pages, v_pages, block_tables,
                         meta):
    """The fused ragged prefill kernel's arithmetic in plain PyTorch (a
    model for the tests; no caller on the card path), with the
    arguments and the in-place page update of
    ``ragged_chunked_prefill_ref``.  Chunk c's token t < chunk_len is
    stored by the CTA of ``PREFILL_CTA_ROWS`` rows that
    ``prefill_writer_tiles`` names, CTA by CTA; then ``_prefill_tiles``
    over one run of positions: ``p < ctx_len`` is row ``p % bs`` of page
    ``tables[c, p // bs]``, ``p >= ctx_len`` row ``p - ctx_len`` of
    k_new / v_new (never the pages just written), and query t sees
    ``p <= ctx_len + min(t, chunk_len - 1)``.  Tiles wholly at ``t >= chunk_len`` and padding
    chunks return zeros.  Returns out (C, T, H, D) in q's dtype."""
    C, T, H, D = q.shape
    _, bs, KV, _ = k_pages.shape
    nb = block_tables.shape[1]
    writer = prefill_writer_tiles(T, H // KV, PREFILL_CTA_ROWS)
    out = torch.empty_like(q)
    for c in range(C):
        ctx, clen = int(meta[c, 1]), min(int(meta[c, 2]), T)
        table = block_tables[c].long()
        for i in range(int(writer.max()) + 1):
            ts = (writer == i).nonzero()[:, 0]
            ts = ts[ts < clen]
            pos = ctx + ts
            page = table[torch.clamp(pos // bs, max=nb - 1)]
            k_pages[page, pos % bs] = k_new[c, ts].to(k_pages.dtype)
            v_pages[page, pos % bs] = v_new[c, ts].to(v_pages.dtype)

        def kv_rows(p, c=c, ctx=ctx, table=table):
            pre = p < ctx
            pp = p[pre]
            page = table[torch.clamp(pp // bs, max=nb - 1)]
            k = torch.empty((len(p), KV, D), dtype=k_pages.dtype)
            v = torch.empty((len(p), KV, D), dtype=v_pages.dtype)
            k[pre], v[pre] = k_pages[page, pp % bs], v_pages[page, pp % bs]
            k[~pre] = k_new[c, p[~pre] - ctx].to(k.dtype)
            v[~pre] = v_new[c, p[~pre] - ctx].to(v.dtype)
            return k, v

        out[c] = _prefill_tiles(
            q[c], KV, clen,
            lambda t, ctx=ctx, clen=clen: ctx + torch.clamp(t, max=clen - 1),
            kv_rows).to(q.dtype)
    return out


def chunked_prefill_tiles(q, k_pages, v_pages, block_tables, ctx_lens):
    """The single-chunk prefill kernel's arithmetic in plain PyTorch (a
    model for the tests; no caller on the card path), with the arguments
    of ``chunked_prefill_attention_ref``: ``_prefill_tiles`` over the
    sequence's ``nb * bs`` positions, ``p`` being row ``p % bs`` of page
    ``tables[b, p // bs]``, query t seeing ``p <= ctx_len + t``.  Table
    entries past the last position the chunk's last query sees are never
    read.  Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    _, bs, KV, _ = k_pages.shape
    n_pos = block_tables.shape[1] * bs
    out = torch.empty_like(q)
    for b in range(B):
        ctx = int(ctx_lens[b])
        table = block_tables[b].long()

        def kv_rows(p, table=table):
            page = table[p // bs]
            return k_pages[page, p % bs], v_pages[page, p % bs]

        out[b] = _prefill_tiles(
            q[b], KV, T,
            lambda t, ctx=ctx: torch.clamp(ctx + t, max=n_pos - 1),
            kv_rows).to(q.dtype)
    return out


def rms_norm_ref(x, weight, eps: float = 1e-6):
    """x (..., D); weight (D,) -> ``x * rsqrt(mean(x^2) + eps) * (1 + w)``
    reduced and scaled in float32, cast to x's dtype (as
    ``models.layers.rms_norm``)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)
