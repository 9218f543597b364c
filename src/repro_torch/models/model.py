"""Top-level model API (PyTorch port of ``repro.models.model``), dense
serving subset:

  * ``init_params(cfg, generator, device)``           parameter dict
  * ``prefill`` / ``decode_step``                     bulk lane (ring cache)
  * ``decode_step_paged`` / ``decode_steps_paged``    paged decode windows
  * ``prefill_chunks``                                fused ragged prefill
  * ``prefill_chunk``                                 one chunk of one prompt

Caches are updated IN PLACE (the reference returns new caches); each
function returns only its outputs.  ``decode_steps_paged`` replaces the
reference's ``lax.scan`` with a Python loop whose tokens stay on the
device, so a window costs no host round trip.
"""

from __future__ import annotations

import torch

from . import layers, transformer


def init_params(cfg, generator: torch.Generator, device,
                dtype=None) -> dict:
    """Seeded random parameters at the reference's init scales (dense
    0.02, embedding 1/sqrt(D), norms zero).  ``generator`` must live on
    ``device``; ``dtype`` defaults to ``cfg.param_dtype``."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    return {
        "embed": layers.init_embedding(generator, cfg, dtype, device),
        "layers": transformer.init_stack(generator, cfg, dtype, device),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }


def _final_logits(params, cfg, x):
    x = layers.rms_norm(x, params["final_ln"], cfg.norm_eps)
    return layers.logits(params["embed"], x, cfg).float()


# ---------------------------------------------------------------------------
# bulk lane: contiguous ring cache
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: dict, cfg, tokens: torch.Tensor, max_len: int,
            cache_dtype=torch.bfloat16):
    """Run the (B, S) prompt through the stack, building a ring cache of
    capacity ``max_len``.  Returns (cache, last_logits (B, V) f32)."""
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens, cfg)
    cache = transformer.init_cache(cfg, B, max_len, cache_dtype,
                                   tokens.device)
    positions = torch.arange(S, device=tokens.device)
    x = transformer.apply_stack(params["layers"], x,
                                {"positions": positions}, cfg, cache,
                                "prefill")
    last_logits = _final_logits(params, cfg, x[:, -1:])[:, 0]
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    cache["slot_pos"] = transformer.prefill_slot_pos(max_len, S,
                                                     tokens.device)
    return cache, last_logits


@torch.no_grad()
def decode_step(params: dict, cfg, cache: dict, token: torch.Tensor):
    """One greedy step for the whole batch at the cache's shared position.
    token (B, 1) i32.  Updates ``cache`` in place; returns
    (next_token (B, 1) i32, logits (B, V) f32)."""
    x = layers.embed(params["embed"], token, cfg)
    ctx = {"pos": cache["pos"], "slot_pos": cache["slot_pos"]}
    x = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                "decode")
    logits = _final_logits(params, cfg, x)[:, 0]
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    cache["pos"] += 1
    return next_token, logits


# ---------------------------------------------------------------------------
# paged cache: decode windows and fused ragged prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step_paged(params: dict, cfg, cache: dict, token: torch.Tensor,
                      tables: torch.Tensor, *, use_kernels: bool):
    """One greedy step of every slot against the paged pool (tables
    (B, nb) i32).  Scatters each slot's K/V and advances ``pos`` in place;
    returns (next_token (B, 1) i32, logits (B, V) f32)."""
    x = layers.embed(params["embed"], token, cfg)
    ctx = {"pos": cache["pos"], "tables": tables, "use_kernels": use_kernels}
    x = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                "decode_paged")
    logits = _final_logits(params, cfg, x)[:, 0]
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    cache["pos"] += 1
    return next_token, logits


@torch.no_grad()
def decode_steps_paged(params: dict, cfg, cache: dict, token: torch.Tensor,
                       tables: torch.Tensor, *, num_steps: int,
                       use_kernels: bool) -> torch.Tensor:
    """``num_steps`` greedy steps with the tables fixed for the whole
    window (the engine pre-extends them).  Returns the window's tokens
    (B, num_steps) i32 on the device; column j is step j's output."""
    toks = []
    for _ in range(num_steps):
        token, _ = decode_step_paged(params, cfg, cache, token, tables,
                                     use_kernels=use_kernels)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1)


@torch.no_grad()
def prefill_chunks(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                   token_chunk: torch.Tensor, meta: torch.Tensor,
                   tables: torch.Tensor, *, chunk_pad: int,
                   use_kernels: bool) -> torch.Tensor:
    """Every scheduled prefill chunk of one engine iteration in one pass.

    tokens (1, TT) packed chunks (chunk ``c`` owns columns
    ``q_off[c] .. q_off[c]+len[c]-1``); token_chunk (TT,) column -> chunk;
    meta (C, 4) rows ``[slot, ctx_len, chunk_len, q_offset]`` (padding
    chunks carry ``chunk_len == 0`` and an out-of-range ``slot``); tables
    (C, nb) block tables; chunk_pad the padded per-chunk view width.

    Writes every chunk's K/V into the pages and sets ``pos[slot] =
    ctx_len + chunk_len`` for the real chunks, in place.  Returns
    last_logits (C, V) f32: row ``c`` holds the logits at chunk ``c``'s
    last position."""
    TT = tokens.shape[1]
    dev = tokens.device
    token_chunk = token_chunk.long()
    meta = meta.to(torch.int32)
    slots, ctx_lens, lens, q_off = meta.unbind(1)
    local = torch.arange(TT, dtype=torch.int32, device=dev) - q_off[token_chunk]
    positions = ctx_lens[token_chunk] + local
    valid = local < lens[token_chunk]
    x = layers.embed(params["embed"], tokens, cfg)
    ctx = {"positions": positions, "token_chunk": token_chunk,
           "local": local, "valid": valid, "meta": meta,
           "table_rows": tables.to(torch.int32), "chunk_pad": chunk_pad,
           "use_kernels": use_kernels}
    x = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                "chunks")
    last_idx = torch.clamp(q_off + torch.clamp(lens, min=1) - 1, 0, TT - 1)
    last_logits = _final_logits(params, cfg, x[:, last_idx.long()])[0]
    # the reference drops the pos update of padding chunks (slot out of
    # range); here they write into one spare entry that is then cut off
    pos = cache["pos"]
    n = pos.shape[0]
    keep = (slots >= 0) & (slots < n)
    idx = torch.where(keep, slots, n).long()
    buf = torch.cat([pos, pos.new_zeros(1)])
    buf[idx] = (ctx_lens + lens).to(pos.dtype)
    pos.copy_(buf[:n])
    return last_logits


@torch.no_grad()
def prefill_chunk(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                  slot: int, table_row: torch.Tensor, ctx_len, *,
                  use_kernels: bool) -> torch.Tensor:
    """Run ONE chunk of one request's prompt against the paged cache.

    tokens (1, T) the chunk's token slice, at absolute positions
    ``ctx_len .. ctx_len + T - 1`` (``ctx_len``: the prompt tokens already
    prefilled, an int or a 0-d tensor); table_row (nb,) i32 the sequence's
    block table, backing every position of the chunk.  Each layer scatters
    the chunk's K/V into its pages and attends full over the prefix,
    causal within the chunk.  Sets ``pos[slot] = ctx_len + T`` in place.
    Returns last_logits (V,) f32 at the chunk's last position: only the
    final chunk's logits feed the sampler."""
    T = tokens.shape[1]
    dev = tokens.device
    positions = (torch.as_tensor(ctx_len, dtype=torch.int32, device=dev)
                 + torch.arange(T, dtype=torch.int32, device=dev))
    x = layers.embed(params["embed"], tokens, cfg)
    x = transformer.prefill_chunk_paged(params["layers"], x, positions,
                                        table_row.to(torch.int32), cfg,
                                        cache, use_kernels)
    last_logits = _final_logits(params, cfg, x[:, -1:])[0, 0]
    cache["pos"][slot] = positions[-1] + 1
    return last_logits
