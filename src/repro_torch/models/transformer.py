"""Dense decoder stack (PyTorch port of ``repro.models.transformer``).

Only the dense kinds the serving path needs are ported.  A list of
per-layer parameter dicts replaces the reference's ``scan0`` stacking, and
caches hold one entry per layer:

  * the contiguous ring cache of the bulk lane (``init_cache``):
    ``{"layers": [{"k", "v"}], "pos": scalar, "slot_pos": (W,)}``;
  * the paged cache of the continuous engine (``init_paged_cache``):
    ``{"layers": [{"k", "v"}], "pos": (num_slots,)}`` with page pools of
    shape ``(num_blocks, block_size, KV, D)``.

Both caches are updated IN PLACE by the functions below (the reference
returns new pytrees).  The paged attention layers run either the
hand-written CUDA kernels (``use_kernels=True``: ``repro_torch.kernels``,
whose wrappers take their plain versions only for CPU tensors) or the
plain path of the reference's ``use_pallas=False`` branch (gather the
logical view, then ``layers.decode_attention`` / ``chunked_attention``),
which the engine runs on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_device
from ..kernels import paged_decode_attention as pfd_kernel
from ..kernels import ragged_chunked_prefill as rcp_kernel
from ..kvcache import paged as paged_lib
from . import layers
from .layers import rms_norm

EMPTY_POS = 2**30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _check_dense(cfg) -> None:
    if cfg.family != "dense" or cfg.window is not None or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: only dense full-attention stacks are ported "
            "(ROADMAP Queue 1 item 9: the other model families)")


def init_attn_mlp_block(generator, cfg, dtype, device) -> dict:
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": layers.init_attention(generator, cfg, dtype, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                               cfg.mlp_act, dtype, device),
    }


def init_stack(generator, cfg, dtype, device) -> list:
    _check_dense(cfg)
    return [init_attn_mlp_block(generator, cfg, dtype, device)
            for _ in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# contiguous ring cache (bulk lane)
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """``device=None`` means the card (raises when none is present)."""
    _check_dense(cfg)
    device = resolve_device(device)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.num_layers)],
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "slot_pos": torch.full((max_len,), EMPTY_POS, dtype=torch.int32,
                                   device=device)}


def prefill_slot_pos(capacity: int, seq_len: int, device
                     ) -> torch.Tensor:
    """Slot -> absolute-position map after prefilling ``seq_len`` tokens
    (the bulk lane never wraps: ``max_len`` exceeds every position)."""
    if seq_len > capacity:
        raise ValueError(f"prefill of {seq_len} tokens exceeds the ring "
                         f"capacity {capacity}")
    out = torch.full((capacity,), EMPTY_POS, dtype=torch.int32,
                     device=device)
    out[:seq_len] = torch.arange(seq_len, dtype=torch.int32, device=device)
    return out


def prefill_write_kv(cache_k, cache_v, k, v) -> None:
    """Write a freshly prefilled sequence (rows 0..S-1) in place."""
    S = k.shape[1]
    cache_k[:, :S] = k.to(cache_k.dtype)
    cache_v[:, :S] = v.to(cache_v.dtype)


def decode_write_kv(cache_k, cache_v, k, v, pos) -> None:
    """Write one token (B, 1, KV, D) at ring slot ``pos % W`` in place
    (``pos`` is the batch's shared scalar position)."""
    idx = pos.long() % cache_k.shape[1]
    cache_k[:, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, idx] = v[:, 0].to(cache_v.dtype)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def paged_supported(cfg) -> tuple[bool, str]:
    """Whether the paged KV path applies (full attention, no recurrent
    or conv state) — the reference's rule."""
    if cfg.family not in ("dense", "moe"):
        return False, (f"family {cfg.family!r} carries recurrent/cross "
                       "state the paged cache does not cover")
    if cfg.window is not None:
        return False, "sliding-window ring cache is already bounded"
    if cfg.frontend:
        return False, "multimodal prefix tokens not paged yet"
    return True, ""


def init_paged_cache(cfg, num_slots: int, num_blocks: int, block_size: int,
                     dtype=torch.bfloat16, device=None) -> dict:
    """``device=None`` means the card (raises when none is present)."""
    ok, why = paged_supported(cfg)
    if not ok:
        raise NotImplementedError(f"paged KV cache: {why}")
    _check_dense(cfg)
    device = resolve_device(device)
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
                       for _ in range(cfg.num_layers)],
            "pos": torch.zeros((num_slots,), dtype=torch.int32,
                               device=device)}


# ---------------------------------------------------------------------------
# attention layers
# ---------------------------------------------------------------------------


def _attn_seq(p, x, positions, cfg):
    """Full-sequence causal self attention (bulk-lane prefill)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.attention_qkv(p["attn"], h, positions, cfg.rope_theta)
    attn = layers.chunked_attention(q, k, v, q_positions=positions,
                                    kv_positions=positions, causal=True)
    return x + layers.attention_out(p["attn"], attn), k, v


def _attn_decode(p, x, cache_k, cache_v, pos, slot_pos, cfg):
    """One-token self attention against the ring cache (batch form:
    scalar ``pos``, (W,) ``slot_pos``); writes K/V and ``slot_pos`` in
    place."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.attention_qkv(p["attn"], h, pos[..., None],
                                   cfg.rope_theta)
    decode_write_kv(cache_k, cache_v, k, v, pos)
    Wc = cache_k.shape[1]
    slot_pos[pos.long() % Wc] = pos
    valid = torch.clamp(pos + 1, max=Wc)
    attn = layers.decode_attention(q, cache_k, cache_v, q_position=pos,
                                   kv_positions=slot_pos, valid_len=valid)
    return x + layers.attention_out(p["attn"], attn)


def _attn_decode_paged(p, x, pages_k, pages_v, pos, tables, cfg,
                       use_kernels: bool):
    """One-token self attention against the paged pool.  The new token is
    scattered first (page ``tables[s, pos[s]//bs]``, in place), then every
    row attends over positions ``< pos + 1``."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.attention_qkv(p["attn"], h, pos[..., None],
                                   cfg.rope_theta)
    paged_lib.scatter_token(pages_k, k[:, 0], tables, pos)
    paged_lib.scatter_token(pages_v, v[:, 0], tables, pos)
    if use_kernels:
        attn = pfd_kernel.paged_flash_decode_attention(
            q[:, 0].contiguous(), pages_k, pages_v, tables, pos + 1)[:, None]
    else:
        k_seq = paged_lib.gather_tokens(pages_k, tables)  # (B, nb*bs, KV, D)
        v_seq = paged_lib.gather_tokens(pages_v, tables)
        L = k_seq.shape[1]
        kv_pos = torch.arange(L, dtype=torch.int32,
                              device=x.device).expand(x.shape[0], L)
        attn = layers.decode_attention(q, k_seq, v_seq, q_position=pos,
                                       kv_positions=kv_pos,
                                       valid_len=pos + 1)
    return x + layers.attention_out(p["attn"], attn)


def _attn_chunks_paged(p, x, pages_k, pages_v, ctx, cfg):
    """Fused ragged chunked-prefill attention over every scheduled chunk
    of one engine iteration (batch dim 1, packed tokens).

    Every chunk's K/V lands in its pages (in place) and each chunk
    attends full over its prefix and causally within itself.  The kernel
    path builds the per-chunk padded views with the clipped packed-row
    index and pre-casts the chunk K/V to the page dtype, as the reference
    does before its Pallas call; the plain path scatters the packed
    stream (padding rows dropped) and runs ``layers.chunked_attention``
    per chunk over the gathered view."""
    positions = ctx["positions"]             # (TT,) absolute positions
    token_chunk = ctx["token_chunk"]         # (TT,) row -> chunk id
    local = ctx["local"]                     # (TT,) row within its chunk
    valid = ctx["valid"]                     # (TT,) False = padding row
    meta = ctx["meta"]                       # (C, 4) i32
    tables = ctx["table_rows"]               # (C, nb) i32
    Tp = ctx["chunk_pad"]                    # padded chunk length
    C = meta.shape[0]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.attention_qkv(p["attn"], h, positions[None, :],
                                   cfg.rope_theta)
    TT = x.shape[1]
    qidx = torch.clamp(meta[:, 3].long()[:, None]
                       + torch.arange(Tp, device=x.device)[None, :],
                       0, TT - 1).reshape(-1)
    if ctx["use_kernels"]:
        qv = q[0][qidx].reshape((C, Tp) + tuple(q.shape[2:]))
        knv = k[0].to(pages_k.dtype)[qidx].reshape(
            (C, Tp) + tuple(k.shape[2:]))
        vnv = v[0].to(pages_v.dtype)[qidx].reshape(
            (C, Tp) + tuple(v.shape[2:]))
        av = rcp_kernel.ragged_chunked_prefill(qv, knv, vnv, pages_k,
                                               pages_v, tables, meta)
    else:
        paged_lib.scatter_packed(pages_k, k[0], tables, token_chunk,
                                 positions, valid)
        paged_lib.scatter_packed(pages_v, v[0], tables, token_chunk,
                                 positions, valid)
        k_seq = paged_lib.gather_tokens(pages_k, tables)  # (C, nb*bs, KV, D)
        v_seq = paged_lib.gather_tokens(pages_v, tables)
        L = k_seq.shape[1]
        kv_pos = torch.arange(L, dtype=torch.int32, device=x.device)
        qc = q[0][qidx].reshape((C, Tp) + tuple(q.shape[2:]))
        ar = torch.arange(Tp, dtype=torch.int32, device=x.device)
        av = torch.stack([
            layers.chunked_attention(
                qc[c:c + 1], k_seq[c:c + 1], v_seq[c:c + 1],
                q_positions=meta[c, 1] + ar, kv_positions=kv_pos,
                causal=True)[0]
            for c in range(C)])              # (C, Tp, H, D)
    # repack: packed row j is row local[j] of chunk token_chunk[j]
    attn = av[token_chunk.long(), torch.clamp(local, 0, Tp - 1).long()][None]
    return x + layers.attention_out(p["attn"], attn)


def _mlp_part(p, x, cfg):
    return x + layers.apply_mlp(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps),
                                cfg.mlp_act)


# ---------------------------------------------------------------------------
# stack application
# ---------------------------------------------------------------------------


def apply_stack(stack: list, x: torch.Tensor, ctx: dict, cfg,
                cache: Optional[dict], mode: str) -> torch.Tensor:
    """Run every layer; ``mode`` is ``prefill`` (bulk lane, fills the ring
    cache), ``decode`` (ring cache), ``decode_paged`` or ``chunks`` (the
    paged cache).  Caches are updated in place; returns the hidden
    states."""
    for i, p in enumerate(stack):
        lc = cache["layers"][i] if cache is not None else None
        if mode == "prefill":
            x, k, v = _attn_seq(p, x, ctx["positions"], cfg)
            if lc is not None:
                prefill_write_kv(lc["k"], lc["v"], k, v)
        elif mode == "decode":
            x = _attn_decode(p, x, lc["k"], lc["v"], ctx["pos"],
                             ctx["slot_pos"], cfg)
        elif mode == "decode_paged":
            x = _attn_decode_paged(p, x, lc["k"], lc["v"], ctx["pos"],
                                   ctx["tables"], cfg, ctx["use_kernels"])
        elif mode == "chunks":
            x = _attn_chunks_paged(p, x, lc["k"], lc["v"], ctx, cfg)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        x = _mlp_part(p, x, cfg)
    return x
