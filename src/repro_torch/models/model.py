"""Top-level model API (PyTorch port of ``repro.models.model``) for every
family: the dense and MoE stacks (``transformer.layer_kinds``) with full
or sliding-window attention, the recurrent stacks (Mamba-2, RG-LRU with
local attention), the vlm decoder behind its projected patches and the
encoder-decoder (a bidirectional encoder, ``cross`` decoder layers):

  * ``init_params(cfg, generator, device)``           parameter dict
  * ``lm_loss(params, cfg, batch)``                   training loss, metrics
  * ``encode``                                        the encdec encoder
  * ``prefill`` / ``decode_step``                     ring cache (batch mode,
                                                      bulk lane, per-slot)
  * ``decode_steps``                                  per-slot decode windows
  * ``prefill_into_slot``                             stall admission, ring
  * ``prefill_into_paged``                            stall admission, pages
  * ``decode_step_paged`` / ``decode_steps_paged``    paged decode windows
  * ``prefill_chunks``                                fused ragged prefill
  * ``prefill_chunk``                                 one chunk of one prompt

Batches, as the reference lays them out: ``tokens`` / ``labels`` (B, S)
int32 for every family; a vlm adds ``patches`` (B, num_patch_tokens, D)
stub ViT embeddings, projected and put before the tokens (positions run
over patches then tokens; the loss covers the text positions); an encdec
adds ``frames`` (B, encoder_seq_len, D) stub audio embeddings, which the
encoder turns into the memory the ``cross`` layers attend to.  The vlm
and encdec families run at model level (``prefill``, ``decode_step``,
``lm_loss``, ``generate``), as in the reference, whose engine builds
batches of tokens only.

Caches are updated IN PLACE (the reference returns new caches); each
serving function returns only its outputs, and like the reference's
serving functions none returns the MoE aux losses (``lm_loss`` does).
``decode_steps`` and ``decode_steps_paged`` replace the reference's
``lax.scan`` with a Python loop whose tokens stay on the device, so a
window costs no host round trip.  The functions the engine captures in
CUDA graphs (both decode windows, both stall admissions,
``prefill_chunks``) read no device value on the host: slot indices may be
1-element device tensors.  ``lm_loss`` runs with autograd; the serving
functions run under ``torch.no_grad``.

Under a sharding policy (``sharding.context.use_policy``) the parameters
are DTensors laid out by ``policy.param_shardings`` and the reference's
constraint sites redistribute the activations; ``prefill`` lays its new
cache out by ``policy.cache_shardings``, and the outputs are DTensors
(``full_tensor()`` gathers them).  The reference activates a policy in
``launch.train --mesh`` and in its dry runs only; so does the port: the
serving engine never does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..sharding import context as shctx
from ..sharding import local as shlocal
from . import layers, multimodal, transformer


def init_encoder(cfg, generator: torch.Generator, dtype, device) -> dict:
    """The bidirectional encoder of an encdec config (seamless's audio
    backbone): ``num_encoder_layers`` attention + MLP blocks as a list,
    the reference's vmapped ``blocks`` one tree a layer, and a final
    norm."""
    return {"blocks": [transformer.init_attn_mlp_block(generator, cfg, dtype,
                                                       device)
                       for _ in range(cfg.num_encoder_layers)],
            "final_ln": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}


def init_params(cfg, generator: torch.Generator, device,
                dtype=None) -> dict:
    """Seeded random parameters at the reference's init scales (dense
    0.02, embedding 1/sqrt(D), norms zero; MoE routers, the SSD mixers'
    ``A_log`` / ``dt_bias`` / ``D`` and the RG-LRU's ``b_a`` / ``b_i`` /
    ``Lambda`` in float32), with an ``encoder`` for an encdec config and
    the ``frontend_proj`` projector for one with a frontend.
    ``generator`` must live on ``device``; ``dtype`` defaults to
    ``cfg.param_dtype``."""
    dtype = dtype or getattr(torch, cfg.param_dtype)
    params = {
        "embed": layers.init_embedding(generator, cfg, dtype, device),
        "layers": transformer.init_stack(generator, cfg, dtype, device),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if cfg.family == "encdec":
        params["encoder"] = init_encoder(cfg, generator, dtype, device)
    if cfg.frontend or cfg.family == "encdec":
        params["frontend_proj"] = multimodal.init_projector(generator, cfg,
                                                            dtype, device)
    return params


def _gathered(params: dict, key: str):
    """``params[key]`` with its "fsdp" dims gathered under a policy."""
    policy = shctx.current()
    if policy is None:
        return params[key]
    return policy.gather_fsdp(params[key], (key,))


def _final_logits(params, cfg, x, use_kernels: bool = False):
    """The final norm (through the RMSNorm kernel on a paged path with the
    kernels) and the logits, in float32."""
    x = transformer.paged_rms_norm(x, params["final_ln"], cfg.norm_eps,
                                   use_kernels)
    return layers.logits(params["embed"], x, cfg).float()


# ---------------------------------------------------------------------------
# encoder and decoder inputs
# ---------------------------------------------------------------------------


def _encoder_layer(p, x, positions, cfg):
    x = shctx.constrain(x, ("batch", "seq", None))
    policy = shctx.current()
    if policy is not None:
        p = policy.gather_fsdp(p, ("encoder", "blocks"))
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.attention_qkv(p["attn"], h, positions, cfg.rope_theta)
    attn = layers.chunked_attention(q, k, v, q_positions=positions,
                                    kv_positions=positions, causal=False)
    x = x + layers.attention_out(p["attn"], attn)
    return x + layers.apply_mlp(
        p["mlp"], layers.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.mlp_act)


def encode(params: dict, cfg, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames (B, Te, D) stub frontend embeddings -> the encoder memory
    (B, Te, D): projected, then every encoder layer with bidirectional
    attention (rope over ``arange(Te)``), then the final norm.  ``remat``
    recomputes each layer in the backward pass."""
    x = multimodal.apply_projector(_gathered(params, "frontend_proj"),
                                   frames)
    x = shctx.constrain(x, ("batch", None, None))
    positions = torch.arange(x.shape[1], device=x.device)
    for p in params["encoder"]["blocks"]:
        if remat:
            x = checkpoint(shctx.under_current(_encoder_layer), p, x,
                           positions, cfg, use_reentrant=False)
        else:
            x = _encoder_layer(p, x, positions, cfg)
    return layers.rms_norm(x, params["encoder"]["final_ln"], cfg.norm_eps)


def _decoder_inputs(params: dict, cfg, tokens: torch.Tensor,
                    patches: Optional[torch.Tensor],
                    frames: Optional[torch.Tensor], remat: bool = False):
    """(x, ctx, num_prefix): the embedded tokens, behind the projected
    patches (cast to the embedding dtype) for a vision frontend; ctx
    with ``positions`` over all of x and, for an encdec config, the
    encoder memory ``enc_out``; num_prefix the patch positions."""
    x = layers.embed(params["embed"], tokens, cfg)
    num_prefix = 0
    if cfg.frontend == "vision":
        if patches is None:
            raise ValueError(f"{cfg.name}: a vision config takes patches=")
        pe = multimodal.apply_projector(_gathered(params, "frontend_proj"),
                                        patches).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
        num_prefix = pe.shape[1]
    x = shctx.constrain(x, ("batch", None, None))
    ctx = {"positions": torch.arange(x.shape[1], device=x.device),
           "enc_out": None}
    if cfg.family == "encdec":
        if frames is None:
            raise ValueError(f"{cfg.name}: an encdec config takes frames=")
        ctx["enc_out"] = encode(params, cfg, frames, remat=remat)
    return x, ctx, num_prefix


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


def chunked_xent(params: dict, cfg, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 1024):
    """x (B, S, D) final hidden states; labels (B, S), < 0 ignored.  The
    sum of the per-token NLL and the token count (float32 scalars), over
    sequence chunks of ``chunk`` as the reference sums them, so the
    (B, S, V) logits never exist at once."""
    S = x.shape[1]
    chunk = min(chunk, S)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, S, chunk):
        lc = labels[:, lo:lo + chunk].long()
        logits = layers.logits(params["embed"], x[:, lo:lo + chunk], cfg)
        logits = shctx.constrain(logits, ("batch", None, "vocab")).float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = _label_logits(logits, lc.clamp(min=0))
        mask = (lc >= 0).float()
        nll_sum = nll_sum + ((logz - ll) * mask).sum()
        count = count + mask.sum()
    return nll_sum, count


def _label_logits(logits, labels):
    """logits (B, c, V) at labels (B, c).  For logits split by vocab under
    a policy, on each rank's shards: the rank whose vocab slice holds a
    label gathers it, the others give zero, and one sum over the vocab
    axes completes it."""
    if not (shlocal.is_dtensor(logits) and shlocal.shard_axes(logits, 2)):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Replicate
    lab = shctx.current().constrain(labels, ("batch", None))
    v0, vn = shlocal.local_range(logits, 2)
    local = lab.to_local() - v0
    inside = (local >= 0) & (local < vn)
    ll = torch.gather(logits.to_local(), -1,
                      local.clamp(0, vn - 1)[..., None])[..., 0]
    ll = shlocal.all_reduce(ll * inside, logits.device_mesh,
                            shlocal.shard_axes(logits, 2))
    return shlocal.wrap(ll, lab, [p if p.is_shard() else Replicate()
                                  for p in lab.placements])


def lm_loss(params: dict, cfg, batch: dict, *, remat: bool = False):
    """Causal-LM loss: the hidden state at text position t predicts
    ``labels[t]`` (labels < 0 ignored), plus the MoE aux loss.  ``batch``
    holds ``tokens``, ``labels`` and, by family, ``patches`` or
    ``frames``.  Returns (loss, metrics): ``loss``, ``xent``, ``tokens``
    (the count), ``moe_aux_loss`` and ``moe_drop_frac``, float32 scalars
    on the device.  Runs with autograd; ``remat`` recomputes each layer
    (decoder and encoder) in the backward pass."""
    x, ctx, num_prefix = _decoder_inputs(
        params, cfg, batch["tokens"], batch.get("patches"),
        batch.get("frames"), remat=remat)
    x, aux = transformer.apply_stack(params["layers"], x, ctx, cfg, None,
                                     "train", remat=remat)
    x = layers.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if num_prefix:
        x = x[:, num_prefix:]
    # gather the (possibly sequence-sharded) final hiddens before the
    # loss's sequence chunks
    x = shctx.constrain(x, ("batch", None, None))
    nll_sum, count = chunked_xent(params, cfg, x, batch["labels"])
    xent = nll_sum / torch.clamp(count, min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    moe_aux = zero + aux["moe_aux_loss"]
    loss = xent + moe_aux
    return loss, {"loss": loss, "xent": xent, "tokens": count,
                  "moe_aux_loss": moe_aux,
                  "moe_drop_frac": zero + aux["moe_drop_frac"]}


# ---------------------------------------------------------------------------
# bulk lane: contiguous ring cache
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(params: dict, cfg, tokens: torch.Tensor, max_len: int,
            cache_dtype=torch.bfloat16, *,
            patches: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """Run the (B, S) prompt through the stack, building a ring cache of
    capacity ``min(window, max_len)``.  A vlm config takes ``patches``
    (B, P, D), which take positions 0..P-1 before the tokens (so
    ``max_len`` must cover P + S + the tokens to decode); an encdec config
    takes ``frames`` (B, Te, D), whose projected encoder K/V each
    ``cross`` layer's cache keeps.  Returns (cache, last_logits (B, V)
    f32) at the last text position."""
    x, ctx, _ = _decoder_inputs(params, cfg, tokens, patches, frames)
    B, S = x.shape[0], x.shape[1]
    cache = transformer.init_cache(cfg, B, max_len, cache_dtype,
                                   tokens.device)
    policy = shctx.current()
    if policy is not None:
        cache["layers"] = policy.distribute(
            cache["layers"], policy.cache_shardings(cache["layers"]))
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
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
    x = shctx.constrain(layers.embed(params["embed"], token, cfg),
                        ("batch", None, None))
    transformer.decode_slot_pos(cache["slot_pos"], cache["pos"])
    ctx = {"pos": cache["pos"], "slot_pos": cache["slot_pos"]}
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                   "decode")
    logits = _final_logits(params, cfg, x)[:, 0]
    next_token = _greedy(logits).to(torch.int32)[:, None]
    cache["pos"] += 1
    return next_token, logits


def _greedy(logits):
    """argmax over the last dim of logits (B, V).  For logits split by
    vocab under a policy, on each rank's shards: the local maximum and its
    first index, the maximum over the vocab axes, and the smallest global
    index that reaches it (``torch.argmax``'s first maximum); DTensor's
    own argmax fails where the batch stays replicated on a split mesh
    axis (B = 1)."""
    if not (shlocal.is_dtensor(logits) and shlocal.shard_axes(logits, 1)):
        return torch.argmax(logits, dim=-1)
    from torch.distributed.tensor import Replicate
    mesh, axes = logits.device_mesh, shlocal.shard_axes(logits, 1)
    v0, _ = shlocal.local_range(logits, 1)
    local = logits.to_local()
    m = local.amax(dim=-1)
    top = shlocal.all_reduce(m, mesh, axes, "max")
    idx = torch.argmax(local, dim=-1) + v0
    far = torch.full_like(idx, logits.shape[1])
    first = -shlocal.all_reduce(-torch.where(m == top, idx, far), mesh,
                                axes, "max")
    return shlocal.wrap(first, logits, [
        Replicate() if p.is_shard() and p.dim == 1 else p
        for p in logits.placements])


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
    x = shctx.constrain(layers.embed(params["embed"], token, cfg),
                        ("batch", None, None))
    ctx = {"pos": cache["pos"], "lens": cache["pos"] + 1, "tables": tables,
           "use_kernels": use_kernels, "rope": cache.get("rope")}
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                   "decode_paged")
    logits = _final_logits(params, cfg, x, use_kernels)[:, 0]
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
    # the packed row of each row of the chunks' padded views (clipped),
    # and the view row of each packed row, for every layer
    qidx = torch.clamp(q_off.long()[:, None]
                       + torch.arange(chunk_pad, device=dev)[None, :],
                       0, TT - 1).reshape(-1)
    repack = (token_chunk * chunk_pad
              + torch.clamp(local, 0, chunk_pad - 1).long())
    x = shctx.constrain(layers.embed(params["embed"], tokens, cfg),
                        ("batch", None, None))
    ctx = {"positions": positions, "token_chunk": token_chunk,
           "valid": valid, "meta": meta, "qidx": qidx, "repack": repack,
           "table_rows": tables.to(torch.int32), "chunk_pad": chunk_pad,
           "use_kernels": use_kernels, "rope": cache.get("rope")}
    x, _ = transformer.apply_stack(params["layers"], x, ctx, cfg, cache,
                                   "chunks")
    last_idx = torch.clamp(q_off + torch.clamp(lens, min=1) - 1, 0, TT - 1)
    last_logits = _final_logits(params, cfg, x[:, last_idx.long()],
                                use_kernels)[0]
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
    x = shctx.constrain(layers.embed(params["embed"], tokens, cfg),
                        ("batch", None, None))
    x, _ = transformer.prefill_chunk_paged(params["layers"], x, positions,
                                           table_row.to(torch.int32), cfg,
                                           cache, use_kernels)
    last_logits = _final_logits(params, cfg, x[:, -1:], use_kernels)[0, 0]
    cache["pos"][slot] = positions[-1] + 1
    return last_logits
