"""Top-level model API (PyTorch port of ``repro.models.model``), serving
subset, for the dense and MoE stacks (``transformer.layer_kinds``) with
full or sliding-window attention, and the recurrent stacks (Mamba-2,
RG-LRU with local attention) on the contiguous caches:

  * ``init_params(cfg, generator, device)``           parameter dict
  * ``prefill`` / ``decode_step``                     ring cache (batch mode,
                                                      bulk lane, per-slot)
  * ``decode_steps``                                  per-slot decode windows
  * ``prefill_into_slot``                             stall admission, ring
  * ``prefill_into_paged``                            stall admission, pages
  * ``decode_step_paged`` / ``decode_steps_paged``    paged decode windows
  * ``prefill_chunks``                                fused ragged prefill
  * ``prefill_chunk``                                 one chunk of one prompt

Caches are updated IN PLACE (the reference returns new caches); each
function returns only its outputs, and like the reference's serving
functions none returns the MoE aux losses (``transformer.apply_stack``
does).  ``decode_steps`` and
``decode_steps_paged`` replace the reference's ``lax.scan`` with a Python
loop whose tokens stay on the device, so a window costs no host round
trip.  The functions the engine captures in CUDA graphs (both decode
windows, both stall admissions, ``prefill_chunks``) read no device value
on the host: slot indices may be 1-element device tensors.
"""

from __future__ import annotations

import torch

from . import layers, transformer


def init_params(cfg, generator: torch.Generator, device,
                dtype=None) -> dict:
    """Seeded random parameters at the reference's init scales (dense
    0.02, embedding 1/sqrt(D), norms zero; MoE routers, the SSD mixers'
    ``A_log`` / ``dt_bias`` / ``D`` and the RG-LRU's ``b_a`` / ``b_i`` /
    ``Lambda`` in float32).
    ``generator`` must live on ``device``; ``dtype`` defaults to
    ``cfg.param_dtype``."""
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
    capacity ``min(window, max_len)``.  Returns (cache, last_logits (B, V)
    f32)."""
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens, cfg)
    cache = transformer.init_cache(cfg, B, max_len, cache_dtype,
                                   tokens.device)
    positions = torch.arange(S, device=tokens.device)
    x, _ = transformer.apply_stack(params["layers"], x,
                                   {"positions": positions}, cfg, cache,
                                   "prefill")
    last_logits = _final_logits(params, cfg, x[:, -1:])[:, 0]
    # a fill, not a host-to-device copy of a Python int: a CUDA graph
    # captures this function (the engine's stall admission)
    cache["pos"] = torch.full((), S, dtype=torch.int32, device=tokens.device)
    cache["slot_pos"] = transformer.prefill_slot_pos(
        cache["slot_pos"].shape[0], S, tokens.device)
    return cache, last_logits


@torch.no_grad()
def decode_step(params: dict, cfg, cache: dict, token: torch.Tensor):
    """One greedy step of every row: at the batch's shared position
    (``init_cache``: scalar ``pos``) or at each row's own
    (``transformer.init_slot_cache``: ``pos`` (B,)).  token (B, 1) i32.
    Updates ``cache`` in place; returns (next_token (B, 1) i32, logits
    (B, V) f32)."""
    x = layers.embed(params["embed"], token, cfg)
    transformer.decode_slot_pos(cache["slot_pos"], cache["pos"])
    ctx = {"pos": cache["pos"], "slot_pos": cache["slot_pos"]}
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                   "decode")
    logits = _final_logits(params, cfg, x)[:, 0]
    next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    cache["pos"] += 1
    return next_token, logits


@torch.no_grad()
def decode_steps(params: dict, cfg, cache: dict, token: torch.Tensor, *,
                 num_steps: int) -> torch.Tensor:
    """``num_steps`` greedy ``decode_step`` calls (the per-slot engine's
    decode window).  Returns the window's tokens (B, num_steps) i32 on the
    device; column j is step j's output."""
    toks = []
    for _ in range(num_steps):
        token, _ = decode_step(params, cfg, cache, token)
        toks.append(token[:, 0])
    return torch.stack(toks, dim=1)


@torch.no_grad()
def prefill_into_slot(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                      slot, max_len: int,
                      cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Prefill ONE (1, S) prompt and write its ring into row ``slot`` of a
    per-slot cache (``transformer.init_slot_cache`` with the same
    ``max_len``), replacing the evicted row, in place.  ``slot``: an int or
    a 1-element int tensor on the cache's device.  Returns last_logits
    (V,) f32."""
    one, last_logits = prefill(params, cfg, tokens, max_len, cache_dtype)
    transformer.write_slot(cache, one, slot)
    return last_logits[0]


@torch.no_grad()
def prefill_into_paged(params: dict, cfg, cache: dict, tokens: torch.Tensor,
                       slot, table_row: torch.Tensor, max_len: int,
                       cache_dtype=torch.bfloat16) -> torch.Tensor:
    """Prefill ONE (1, S) prompt and scatter its K/V into the pages of
    ``table_row`` (nb,), setting ``pos[slot] = S``, in place.  ``slot``: an
    int or a 1-element int tensor on the cache's device.  Returns
    last_logits (V,) f32."""
    one, last_logits = prefill(params, cfg, tokens, max_len, cache_dtype)
    transformer.write_paged(cache, one, slot, table_row, tokens.shape[1])
    return last_logits[0]


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
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
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
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
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
    x, _ = transformer.prefill_chunk_paged(params["layers"], x, positions,
                                           table_row.to(torch.int32), cfg,
                                           cache, use_kernels)
    last_logits = _final_logits(params, cfg, x[:, -1:])[0, 0]
    cache["pos"][slot] = positions[-1] + 1
    return last_logits
