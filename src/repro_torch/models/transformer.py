"""Decoder stacks (PyTorch port of ``repro.models.transformer``): dense
and MoE, with full or sliding-window attention; Mamba-2 (``ssm``);
Griffin's RG-LRU blocks with local attention (``hybrid``); the vlm
decoder (dense layers behind projected patches); and the encoder-decoder
decoder, whose ``cross`` layers add cross attention to the encoder
memory.

The reference's stack layout (``stack_pattern``: the dense prefix, the
scanned groups, the tail) is kept as a flat list of per-layer parameter
dicts, each layer of the kind ``layer_kinds`` gives it, and caches hold
one entry per layer:

  * the contiguous cache of batch mode and the bulk lane
    (``init_cache``): ``{"layers": [...], "pos": scalar, "slot_pos":
    (W,)}``.  An attention layer holds a ``{"k", "v"}`` ring of
    ``min(window, max_len)`` rows (``local_window`` for ``attn_local``),
    an ``ssm`` layer ``{"conv", "ssd"}`` and a ``rec`` layer ``{"conv",
    "h"}`` (the conv tail in the cache dtype, the recurrent state in
    float32); a ``cross`` layer adds ``enc_k`` / ``enc_v`` (B,
    encoder_seq_len, KV, D), the projected encoder memory a prefill
    writes and decode attends to; W is the attention rings' width, 1 for
    an ``ssm`` stack;
  * the per-slot ring cache of the contiguous continuous engine
    (``init_slot_cache``): the same layers with ``pos`` (C,) and
    ``slot_pos`` (C, W), one independent sequence a row;
  * the paged cache of the paged continuous engine
    (``init_paged_cache``, full attention only): ``{"layers": [{"k",
    "v"}], "pos": (num_slots,)}`` with page pools of shape
    ``(num_blocks, block_size, KV, D)``.

Both caches are updated IN PLACE by the functions below (the reference
returns new pytrees).  The paged attention layers (decode, the fused
ragged prefill and the single-chunk prefill) run either the hand-written
CUDA kernels (``use_kernels=True``: ``repro_torch.kernels``, whose wrappers
take their plain versions only for CPU tensors) or the plain path of the
reference's ``use_pallas=False`` branch (gather the logical view, then
``layers.decode_attention`` / ``chunked_attention``), which the engine runs
on the CPU.  With the kernels, the pointwise chains around a paged layer's
projections run fused too: ``ln1`` through the RMSNorm kernel, RoPE and
the K/V page write as one ``kernels.rope_kv`` launch, and the attention
residual add with ``ln2`` as one ``kernels.rms_norm.add_rms_norm``
launch (``build_paged_kernels`` compiles every library these paths
launch, all at once).

A prefill replaces a recurrent layer's state leaves with the ones it
computed (in the compute dtype, as the reference returns them); every
other write, decode included, goes into the cache's own tensors, which
is what the engine's CUDA graphs bind.  The recurrent, multimodal and
encoder-decoder families have no paged cache (``paged_supported``).

Under a sharding policy (``repro_torch.sharding``) the parameters and
the contiguous caches are DTensors: each layer constrains its input as
the reference's ``apply_block_*`` do (the residual stream by batch, and
by sequence under ``seq_parallel`` in the sequence modes), and the
in-place cache writes run on each rank's shards (DTensor has no rule
for them).

``apply_stack(..., mode="train")`` is the training forward: no cache, no
write into any tensor it was given, so autograd runs through it; with
``remat=True`` each layer of the reference's scanned superblocks runs
under ``torch.utils.checkpoint``, the counterpart of its
``jax.checkpoint``; the prefix and tail layers (kimi-k2's dense layers,
a hybrid's last partial pattern) keep their activations, as the
reference's unrolled ones do.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..kernels import _build
from ..kernels import chunked_prefill_attention as cpa_kernel
from ..kernels import paged_decode_attention as pfd_kernel
from ..kernels import ragged_chunked_prefill as rcp_kernel
from ..kernels import rms_norm as rms_kernel
from ..kernels import rope_kv
from ..kvcache import paged as paged_lib
from ..sharding import context as shctx
from ..sharding import local as shlocal
from . import layers, moe as moe_lib, rglru, ssm
from .layers import rms_norm

EMPTY_POS = 2**30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def stack_pattern(cfg):
    """(pattern, n_repeats, prefix_kinds, tail_kinds) of the reference
    (transformer.py:513): MoE stacks lead with ``num_dense_layers`` dense
    layers; a hybrid repeats its ``block_pattern`` and ends in the
    pattern's first ``num_layers % len(pattern)`` kinds; an encdec
    decoder is ``cross`` layers, a vlm decoder dense ones."""
    if cfg.family == "moe":
        return (("moe",), cfg.num_layers - cfg.num_dense_layers,
                ("dense",) * cfg.num_dense_layers, ())
    if cfg.family == "ssm":
        return ("ssm",), cfg.num_layers, (), ()
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn_local")
        n = cfg.num_layers // len(pat)
        return pat, n, (), pat[:cfg.num_layers - n * len(pat)]
    kind = "cross" if cfg.family == "encdec" else "dense"
    return (kind,), cfg.num_layers, (), ()


def layer_kinds(cfg) -> tuple:
    """Every layer's kind, in the order of the port's flat layer list:
    the prefix, the pattern repeated, the tail."""
    pat, n, prefix, tail = stack_pattern(cfg)
    return prefix + pat * n + tail


def kv_cache_capacity(max_len: int, window: Optional[int]) -> int:
    """A ring's rows: a sliding window needs only its last ``window``."""
    return min(window, max_len) if window else max_len


def init_attn_mlp_block(generator, cfg, dtype, device, *,
                        use_moe: bool = False, cross: bool = False) -> dict:
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "attn": layers.init_attention(generator, cfg, dtype, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }
    if use_moe:
        p["moe"] = moe_lib.init_moe(generator, cfg, dtype, device)
    else:
        p["mlp"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                   cfg.mlp_act, dtype, device)
    if cross:
        p["ln_x"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
        p["xattn"] = layers.init_attention(generator, cfg, dtype, device)
    return p


def init_ssm_block(generator, cfg, dtype, device) -> dict:
    return {"ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
            "mixer": ssm.init_mamba2(generator, cfg, dtype, device)}


def init_rec_block(generator, cfg, dtype, device) -> dict:
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=dtype,  # noqa: E731
                                device=device)
    return {"ln1": zeros(),
            "rec": rglru.init_rglru_block(generator, cfg, dtype, device),
            "ln2": zeros(),
            "mlp": layers.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                   cfg.mlp_act, dtype, device)}


def init_stack(generator, cfg, dtype, device) -> list:
    def one(kind):
        if kind == "ssm":
            return init_ssm_block(generator, cfg, dtype, device)
        if kind == "rec":
            return init_rec_block(generator, cfg, dtype, device)
        return init_attn_mlp_block(generator, cfg, dtype, device,
                                   use_moe=kind == "moe",
                                   cross=kind == "cross")
    return [one(kind) for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# contiguous ring cache (bulk lane)
# ---------------------------------------------------------------------------


def _layer_window(kind: str, cfg) -> Optional[int]:
    """An attention layer's window: ``local_window`` for ``attn_local``."""
    return cfg.local_window if kind == "attn_local" else cfg.window


def _layer_cache(kind, cfg, batch, max_len, dtype, device) -> dict:
    """One layer's zero cache (the reference's ``_layer_cache_zeros``)."""
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    if kind == "ssm":
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {"conv": z(batch, cfg.ssm_conv_width - 1, conv_dim),
                "ssd": z(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state, dt=torch.float32)}
    if kind == "rec":
        lw = cfg.lru_width or cfg.d_model
        return {"conv": z(batch, cfg.ssm_conv_width - 1, lw),
                "h": z(batch, lw, dt=torch.float32)}
    cap = kv_cache_capacity(max_len, _layer_window(kind, cfg))
    c = {"k": z(batch, cap, cfg.num_kv_heads, cfg.head_dim),
         "v": z(batch, cap, cfg.num_kv_heads, cfg.head_dim)}
    if kind == "cross":
        enc = (batch, cfg.encoder_seq_len, cfg.num_kv_heads, cfg.head_dim)
        c["enc_k"], c["enc_v"] = z(*enc), z(*enc)
    return c


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """One zero cache a layer (``_layer_cache``); ``slot_pos`` as wide as
    the attention rings (``cfg.window``, a hybrid's ``local_window``),
    1 for an ``ssm`` stack.  ``device=None`` means the card (raises when
    none is present)."""
    device = resolve_device(device)
    cache = [_layer_cache(kind, cfg, batch, max_len, dtype, device)
             for kind in layer_kinds(cfg)]
    window = cfg.window or (cfg.local_window if cfg.family == "hybrid"
                            else None)
    cap = 1 if cfg.family == "ssm" else kv_cache_capacity(max_len, window)
    return {"layers": cache,
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "slot_pos": torch.full((cap,), EMPTY_POS, dtype=torch.int32,
                                   device=device)}


def prefill_slot_pos(capacity: int, seq_len: int, device
                     ) -> torch.Tensor:
    """Slot -> absolute-position map after prefilling ``seq_len`` tokens
    from position 0.  A prefill at least as long as the ring keeps its
    last ``capacity`` positions, rolled by ``seq_len % capacity`` so that
    position ``p`` sits in slot ``p % capacity`` (the reference's rule)."""
    if seq_len >= capacity:
        return torch.roll(torch.arange(seq_len - capacity, seq_len,
                                       dtype=torch.int32, device=device),
                          seq_len % capacity)
    out = torch.full((capacity,), EMPTY_POS, dtype=torch.int32,
                     device=device)
    out[:seq_len] = torch.arange(seq_len, dtype=torch.int32, device=device)
    return out


def prefill_write_kv(cache_k, cache_v, k, v) -> None:
    """Write a freshly prefilled sequence (positions 0..S-1) into the
    (B, W, KV, D) ring in place: rows 0..S-1 when it fits, else its last
    W rows rolled by ``S % W`` (slot ``p % W`` holds position ``p``).  A
    DTensor ring is written on each rank's shard (its rows s0..s0+n)."""
    Wc = cache_k.shape[1]
    S = k.shape[1]
    s0, sn = shlocal.local_range(cache_k, 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        if shlocal.is_dtensor(cache):
            new = shlocal.layout_like(new, cache, whole_dim=1).to_local()
            cache = cache.to_local()
        if S >= Wc:
            cache.copy_(torch.roll(new[:, S - Wc:], S % Wc,
                                   dims=1)[:, s0:s0 + sn])
        else:
            n = max(0, min(sn, S - s0))
            cache[:, :n] = new[:, s0:s0 + n].to(cache.dtype)


def decode_write_kv(cache_k, cache_v, k, v, pos) -> None:
    """Write one token (B, 1, KV, D) at ring slot ``pos % W`` in place.
    ``pos`` is the batch's shared scalar position, or (B,) per-slot
    positions, each row then writing at its own ring slot.  A DTensor
    ring is written on each rank's shard, where the slot lies in it."""
    idx = pos.long() % cache_k.shape[1]
    if shlocal.is_dtensor(cache_k):
        _decode_write_shards(cache_k, cache_v, k, v, idx)
        return
    if idx.ndim:
        rows = torch.arange(cache_k.shape[0], device=idx.device)
        cache_k[rows, idx] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, idx] = v[:, 0].to(cache_v.dtype)
        return
    # a 1-element index: no host read of ``pos``
    cache_k.index_copy_(1, idx.reshape(1), k.to(cache_k.dtype))
    cache_v.index_copy_(1, idx.reshape(1), v.to(cache_v.dtype))


def _decode_write_shards(cache_k, cache_v, k, v, idx) -> None:
    """``decode_write_kv`` on the local shards of a DTensor ring: the rank
    whose sequence slice holds the slot writes it, the others keep their
    rows (no host read of ``pos``)."""
    b0, bn = shlocal.local_range(cache_k, 0)
    s0, sn = shlocal.local_range(cache_k, 1)
    li = idx - s0
    inside = (li >= 0) & (li < sn)
    li = li.clamp(0, sn - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        new = shlocal.layout_like(new, cache, whole_dim=1).to_local()
        cache = cache.to_local()
        new = new[:, 0].to(cache.dtype)
        if idx.ndim:
            rows = torch.arange(bn, device=idx.device)
            at, keep = li[b0:b0 + bn], inside[b0:b0 + bn, None, None]
            cache[rows, at] = torch.where(keep, new, cache[rows, at])
        else:
            at = li.reshape(1)
            cache.index_copy_(1, at, torch.where(
                inside, new[:, None], cache.index_select(1, at)))


def init_slot_cache(cfg, num_slots: int, max_len: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    """A ring cache whose ``pos`` (C,) and ``slot_pos`` (C, W) are kept
    per slot, so each row runs an independent sequence (the contiguous
    continuous engine); W as ``init_cache``.  ``device=None`` means the
    card."""
    cache = init_cache(cfg, num_slots, max_len, dtype, device)
    dev = cache["pos"].device
    cache["pos"] = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
    cache["slot_pos"] = cache["slot_pos"][None].repeat(num_slots, 1)
    return cache


def write_slot(cache: dict, one: dict, slot) -> None:
    """Write a freshly prefilled single-sequence cache (batch 1, scalar
    ``pos``, (W,) ``slot_pos``: what ``model.prefill`` returns for a
    (1, S) prompt) into row ``slot`` of a per-slot cache, in place, each
    leaf cast to the per-slot cache's dtype.  Every K/V row, recurrent
    state and the ``slot_pos`` row of the slot are replaced, so nothing
    of an evicted sequence survives.  ``slot``: an int or a 1-element int
    tensor on the cache's device (``paged.as_index``)."""
    idx = paged_lib.as_index(slot, cache["pos"].device)
    for lc, lo in zip(cache["layers"], one["layers"]):
        for key, t in lc.items():
            t.index_copy_(0, idx, lo[key].to(t.dtype))
    cache["pos"].index_copy_(0, idx,
                             one["pos"].reshape(1).to(cache["pos"].dtype))
    cache["slot_pos"].index_copy_(
        0, idx, one["slot_pos"][None].to(cache["slot_pos"].dtype))


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
                     dtype=torch.bfloat16, device=None,
                     rope_len: Optional[int] = None) -> dict:
    """``device=None`` means the card (raises when none is present).  Off
    the CPU the cache also holds ``rope``, the cos/sin table
    (``layers.rope_table``) the fused RoPE + K/V write reads, one row per
    position a sequence can reach: ``rope_len`` rows, or without it one
    per position of the whole pool.  It is built here, before any graph
    is captured, and the graphs bind it with the pages."""
    ok, why = paged_supported(cfg)
    if not ok:
        raise NotImplementedError(f"paged KV cache: {why}")
    device = resolve_device(device)
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    cache = {"layers": [{"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype, device=device)}
                        for _ in range(cfg.num_layers)],
             "pos": torch.zeros((num_slots,), dtype=torch.int32,
                                device=device)}
    if device.type != "cpu":
        cache["rope"] = layers.rope_table(
            cfg.head_dim, cfg.rope_theta,
            rope_len if rope_len is not None else num_blocks * block_size,
            device)
    return cache


def write_paged(cache: dict, one: dict, slot, table_row: torch.Tensor,
                seq_len: int) -> None:
    """Scatter a freshly prefilled single-sequence ring cache (batch 1,
    positions 0..S-1 at rows 0..S-1) into the page pools at the blocks
    of ``table_row`` (nb,) and set ``pos[slot] = seq_len``, in place.
    ``slot``: an int or a 1-element int tensor (``paged.as_index``)."""
    for lc, lo in zip(cache["layers"], one["layers"]):
        paged_lib.scatter_prefill(lc["k"], lo["k"][0], table_row, seq_len)
        paged_lib.scatter_prefill(lc["v"], lo["v"][0], table_row, seq_len)
    cache["pos"].index_fill_(
        0, paged_lib.as_index(slot, cache["pos"].device), seq_len)


def copy_paged_block(cache: dict, src, dst) -> None:
    """Copy-on-write page copy: physical block ``src`` into ``dst`` in
    every layer's K/V pools, in place.  ``src``/``dst``: ints or
    1-element int tensors (``paged.as_index``)."""
    for lc in cache["layers"]:
        paged_lib.copy_block(lc["k"], src, dst)
        paged_lib.copy_block(lc["v"], src, dst)


# ---------------------------------------------------------------------------
# attention layers
# ---------------------------------------------------------------------------


def _attn_seq(p, x, positions, cfg, window):
    """Full-sequence causal self attention (a prefill into a ring): the
    sliding-window scheme when ``window`` is shorter than the sequence,
    as the reference (transformer.py:149)."""
    h = _gather_seq(rms_norm(x, p["ln1"], cfg.norm_eps))
    q, k, v = layers.attention_qkv(p["attn"], h, positions, cfg.rope_theta)
    if window is not None and window < x.shape[1]:
        attn = layers.windowed_attention(q, k, v, q_positions=positions,
                                         kv_positions=positions,
                                         window=window)
    else:
        attn = layers.chunked_attention(q, k, v, q_positions=positions,
                                        kv_positions=positions, causal=True,
                                        window=window)
    return x + layers.attention_out(p["attn"], attn), k, v


def decode_slot_pos(slot_pos, pos) -> None:
    """Record the decoded token's position ``pos`` at ring slot ``pos %
    W`` of ``slot_pos`` (W,) or, per row, (B, W), in place (the
    reference's ``decode_step`` bookkeeping)."""
    Wc = slot_pos.shape[-1]
    if pos.ndim:
        rows = torch.arange(slot_pos.shape[0], device=pos.device)
        slot_pos[rows, pos.long() % Wc] = pos
    else:       # a 1-element index: no host read of ``pos``
        slot_pos.index_put_(((pos.long() % Wc).reshape(1),), pos.reshape(1))


def _attn_decode(p, x, cache_k, cache_v, pos, slot_pos, cfg, window):
    """One-token self attention against the ring cache: scalar ``pos``
    with (W,) ``slot_pos`` (batch mode), or (B,) ``pos`` with (B, W)
    ``slot_pos`` (per-slot, every row its own sequence), ``slot_pos``
    already holding ``pos`` (``decode_slot_pos``); writes K/V in place.
    Keys more than ``window`` back are masked (a wrapped ring has
    overwritten most of them already)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.attention_qkv(p["attn"], h, pos[..., None],
                                   cfg.rope_theta)
    decode_write_kv(cache_k, cache_v, k, v, pos)
    Wc = cache_k.shape[1]
    valid = torch.clamp(pos + 1, max=Wc)
    attn = layers.decode_attention(q, cache_k, cache_v, q_position=pos,
                                   kv_positions=slot_pos, valid_len=valid,
                                   window=window)
    return x + layers.attention_out(p["attn"], attn)


#: the kernel modules the paged paths launch with ``use_kernels``
PAGED_KERNELS = (pfd_kernel, rcp_kernel, cpa_kernel, rms_kernel, rope_kv)


def build_paged_kernels() -> dict:
    """Compile every library of ``PAGED_KERNELS`` not built yet, all at
    once (``_build.build``); seconds per library."""
    return _build.build([m.NAME for m in PAGED_KERNELS])


def paged_rms_norm(x, weight, eps: float, use_kernels: bool):
    """RMSNorm on a paged path: the kernel's wrapper with the kernels,
    else the plain version."""
    if use_kernels:
        return rms_kernel.rms_norm(x, weight, eps)
    return rms_norm(x, weight, eps)


def _paged_residual(p, x, out, cfg, use_kernels: bool):
    """The attention branch's output added to the residual stream, and
    ``ln2`` of the sum: one launch with the kernels.  Returns (sum, its
    norm), the MLP's residual and input."""
    if use_kernels:
        return rms_kernel.add_rms_norm(x, out, p["ln2"], cfg.norm_eps)
    x = x + out
    return x, rms_norm(x, p["ln2"], cfg.norm_eps)


def _attn_decode_paged(p, x, lc, ctx, cfg):
    """One-token self attention against the paged pool (``ctx``: ``pos``
    (B,), ``lens`` = pos + 1, ``tables``).  The new token is scattered
    first (page ``tables[s, pos[s]//bs]``, in place), then every row
    attends over positions ``< pos + 1``.  Returns (x + attention, ``ln2``
    of it)."""
    pages_k, pages_v = lc["k"], lc["v"]
    pos, tables, use_kernels = ctx["pos"], ctx["tables"], ctx["use_kernels"]
    h = paged_rms_norm(x, p["ln1"], cfg.norm_eps, use_kernels)
    if use_kernels:
        q, k, v = layers.attention_proj(p["attn"], h)
        q = rope_kv.rope_kv_decode(q, k, v, pos, tables, pages_k, pages_v,
                                   theta=cfg.rope_theta,
                                   table=ctx.get("rope"))
        attn = pfd_kernel.paged_flash_decode_attention(
            q, pages_k, pages_v, tables, ctx["lens"])[:, None]
    else:
        q, k, v = layers.attention_qkv(p["attn"], h, pos[..., None],
                                       cfg.rope_theta)
        paged_lib.scatter_token(pages_k, k[:, 0], tables, pos)
        paged_lib.scatter_token(pages_v, v[:, 0], tables, pos)
        k_seq = paged_lib.gather_tokens(pages_k, tables)  # (B, nb*bs, KV, D)
        v_seq = paged_lib.gather_tokens(pages_v, tables)
        L = k_seq.shape[1]
        kv_pos = torch.arange(L, dtype=torch.int32,
                              device=x.device).expand(x.shape[0], L)
        attn = layers.decode_attention(q, k_seq, v_seq, q_position=pos,
                                       kv_positions=kv_pos,
                                       valid_len=ctx["lens"])
    return _paged_residual(p, x, layers.attention_out(p["attn"], attn), cfg,
                           use_kernels)


def _attn_chunk_paged(p, x, lc, ctx, cfg):
    """Chunked-prefill self attention for ONE sequence (batch dim 1).

    x (1, T, D) the in-flight chunk; ``ctx["positions"]`` (T,) its
    absolute positions ``ctx_len .. ctx_len + T - 1``;
    ``ctx["table_row"]`` (nb,) i32.  The chunk's K/V are scattered into
    the page pools first (in place), then the queries attend over the
    sequence's pages: full over the prefix, causal within the chunk,
    through the chunked-prefill kernel or the plain path of the reference
    (gather the logical view, then ``layers.chunked_attention``, the
    recipe of the fused path, so the two agree bit for bit).  Returns (x +
    attention, ``ln2`` of it)."""
    pages_k, pages_v = lc["k"], lc["v"]
    positions, table_row = ctx["positions"], ctx["table_row"]
    use_kernels = ctx["use_kernels"]
    h = paged_rms_norm(x, p["ln1"], cfg.norm_eps, use_kernels)
    if use_kernels:
        q, k, v = layers.attention_proj(p["attn"], h)
        q, k, _ = rope_kv.rope_kv_packed(q[0], k[0], None, positions,
                                         theta=cfg.rope_theta,
                                         table=ctx.get("rope"))
        paged_lib.scatter_chunk(pages_k, k, table_row, positions[0])
        paged_lib.scatter_chunk(pages_v, v[0], table_row, positions[0])
        attn = cpa_kernel.chunked_prefill_attention(
            q[None], pages_k, pages_v, table_row[None, :], positions[:1])
    else:
        q, k, v = layers.attention_qkv(p["attn"], h, positions[None, :],
                                       cfg.rope_theta)
        paged_lib.scatter_chunk(pages_k, k[0], table_row, positions[0])
        paged_lib.scatter_chunk(pages_v, v[0], table_row, positions[0])
        k_seq = paged_lib.gather_tokens(pages_k, table_row[None, :])
        v_seq = paged_lib.gather_tokens(pages_v, table_row[None, :])
        L = k_seq.shape[1]
        attn = layers.chunked_attention(
            q, k_seq, v_seq, q_positions=positions,
            kv_positions=torch.arange(L, dtype=torch.int32, device=x.device),
            causal=True)
    return _paged_residual(p, x, layers.attention_out(p["attn"], attn), cfg,
                           use_kernels)


def _attn_chunks_paged(p, x, lc, ctx, cfg):
    """Fused ragged chunked-prefill attention over every scheduled chunk
    of one engine iteration (batch dim 1, packed tokens).

    Every chunk's K/V lands in its pages (in place) and each chunk
    attends full over its prefix and causally within itself.  Both paths
    build the per-chunk padded views from the clipped packed-row index
    ``qidx`` and repack the output by ``repack`` (both in ``ctx``, shared
    by the layers).  The kernel path rotates q and k and gathers the views
    (K/V in the page dtype, as the reference casts them before its Pallas
    call) in one ``rope_kv`` launch, and the ragged kernel scatters the
    chunk K/V; the plain path scatters the packed stream (padding rows
    dropped) and runs ``layers.chunked_attention`` per chunk over the
    gathered view.  Returns (x + attention, ``ln2`` of it)."""
    pages_k, pages_v = lc["k"], lc["v"]
    positions = ctx["positions"]             # (TT,) absolute positions
    meta = ctx["meta"]                       # (C, 4) i32
    tables = ctx["table_rows"]               # (C, nb) i32
    qidx = ctx["qidx"]                       # (C * Tp,) packed row of each
    Tp = ctx["chunk_pad"]                    # padded chunk length
    use_kernels = ctx["use_kernels"]
    C = meta.shape[0]
    h = paged_rms_norm(x, p["ln1"], cfg.norm_eps, use_kernels)
    if use_kernels:
        q, k, v = layers.attention_proj(p["attn"], h)
        qv, knv, vnv = rope_kv.rope_kv_packed(
            q[0], k[0], v[0], positions, qidx, theta=cfg.rope_theta,
            table=ctx.get("rope"))
        av = rcp_kernel.ragged_chunked_prefill(
            qv.view((C, Tp) + tuple(q.shape[2:])),
            knv.to(pages_k.dtype).view((C, Tp) + tuple(k.shape[2:])),
            vnv.to(pages_v.dtype).view((C, Tp) + tuple(v.shape[2:])),
            pages_k, pages_v, tables, meta)
    else:
        q, k, v = layers.attention_qkv(p["attn"], h, positions[None, :],
                                       cfg.rope_theta)
        token_chunk, valid = ctx["token_chunk"], ctx["valid"]
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
    attn = av.reshape((C * Tp,) + tuple(av.shape[2:]))[ctx["repack"]][None]
    return _paged_residual(p, x, layers.attention_out(p["attn"], attn), cfg,
                           use_kernels)


def _project_enc_kv(p, enc_out):
    """Per-layer K/V projections of the shared encoder memory (no rope)."""
    enc_k = torch.einsum("bsd,dhk->bshk", enc_out, p["xattn"]["wk"])
    enc_v = torch.einsum("bsd,dhk->bshk", enc_out, p["xattn"]["wv"])
    return enc_k, enc_v


def _cross_attn(p, x, enc_k, enc_v, cfg):
    """Cross attention against the projected encoder memory: no rope on
    either side, and every query at position ``Te``, so each sees all Te
    encoder rows (the reference's transformer.py:355)."""
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["xattn"]["wq"])
    Te = enc_k.shape[1]
    pos_q = torch.full((x.shape[1],), Te, dtype=torch.int32, device=x.device)
    attn = layers.chunked_attention(
        q, enc_k, enc_v, q_positions=pos_q,
        kv_positions=torch.arange(Te, dtype=torch.int32, device=x.device),
        causal=False)
    return x + torch.einsum("bshk,hkd->bsd", attn, p["xattn"]["wo"])


def _refuse_paged(kind: str, mode: str) -> None:
    """The paged modes take only dense and MoE layers (the reference's
    ``apply_block_chunk`` / ``apply_block_chunks``)."""
    what = "paged decode" if mode == "decode_paged" else "chunked prefill"
    if mode not in ("decode_paged", "chunk", "chunks"):
        raise ValueError(f"unknown mode {mode!r}")
    raise NotImplementedError(
        f"{what} requires a paged-eligible stack (got {kind!r})")


def _recurrent_layer(kind, p, x, cfg, lc, mode):
    """An ``ssm`` layer, ``x + mixer(rms_norm(x))`` with no MLP, or a
    ``rec`` layer, ``mlp_part(x + rec(rms_norm(x)))``.  A prefill starts
    from the layer cache's state, as the reference does, and replaces its
    leaves (a training forward has no cache); a decode step updates them
    in place."""
    if mode not in ("prefill", "train", "decode"):
        _refuse_paged(kind, mode)
    h = rms_norm(x, p["ln" if kind == "ssm" else "ln1"], cfg.norm_eps)
    if mode != "decode":
        apply = (ssm.apply_mamba2 if kind == "ssm"
                 else rglru.apply_recurrent_block)
        y, state = apply(p["mixer" if kind == "ssm" else "rec"], h, cfg, lc)
        if lc is not None:
            lc.update(state)
    elif kind == "ssm":
        y = ssm.decode_mamba2(p["mixer"], h, cfg, lc)
    else:
        y = rglru.decode_recurrent_block(p["rec"], h, cfg, lc)
    return x + y if kind == "ssm" else _mlp_part(p, x + y, cfg)


def _gather_seq(h):
    """A sequence-sharded (``seq_parallel``) block input gathered over the
    sequence before the block's projections, Korthikanti-style: the
    residual stream and norms stay sharded, the products see whole
    sequences (a no-op in every other layout)."""
    return shctx.constrain(h, ("batch", None, None))


def _mlp_part(p, x, cfg, h=None):
    """``x + mlp(ln2(x))``; ``h``, where given, is ``ln2(x)`` already."""
    if h is None:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.apply_mlp(p["mlp"], _gather_seq(h), cfg.mlp_act)


def _moe_part(p, x, cfg, h=None):
    if h is None:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = moe_lib.apply_moe(p["moe"], h, cfg)
    return x + y, aux


# ---------------------------------------------------------------------------
# stack application
# ---------------------------------------------------------------------------


def _apply_layer(kind, p, x, ctx, cfg, lc, mode):
    """One layer of any kind in any mode.  Returns (x, aux): a MoE
    layer's aux dict, None for the other kinds.  The input is constrained
    as the reference's ``apply_block_*`` do: by batch, and in the sequence
    modes by sequence too ("seq" resolves to "model" only under the
    policy's ``seq_parallel``)."""
    x = shctx.constrain(x, ("batch", "seq" if mode in ("prefill", "train")
                            else None, None))
    policy = shctx.current()
    if policy is not None:
        p = policy.gather_fsdp(p, ("layers",))
    if kind in ("ssm", "rec"):
        return _recurrent_layer(kind, p, x, cfg, lc, mode), None
    window = _layer_window(kind, cfg)
    h = None                # ln2(x), where a paged layer computed it
    if mode in ("prefill", "train"):
        x, k, v = _attn_seq(p, x, ctx["positions"], cfg, window)
        if lc is not None:
            prefill_write_kv(lc["k"], lc["v"], k, v)
    elif mode == "decode":
        x = _attn_decode(p, x, lc["k"], lc["v"], ctx["pos"],
                         ctx["slot_pos"], cfg, window)
    elif kind in ("attn_local", "cross"):
        _refuse_paged(kind, mode)
    elif mode == "decode_paged":
        x, h = _attn_decode_paged(p, x, lc, ctx, cfg)
    elif mode == "chunk":
        x, h = _attn_chunk_paged(p, x, lc, ctx, cfg)
    elif mode == "chunks":
        x, h = _attn_chunks_paged(p, x, lc, ctx, cfg)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if kind == "cross":
        if mode == "decode":
            enc_k, enc_v = lc["enc_k"], lc["enc_v"]
        else:
            enc_k, enc_v = _project_enc_kv(p, ctx["enc_out"])
            if lc is not None:
                shlocal.copy_into(lc["enc_k"], enc_k)
                shlocal.copy_into(lc["enc_v"], enc_v)
        x = _cross_attn(p, x, enc_k, enc_v, cfg)
    if kind == "moe":
        return _moe_part(p, x, cfg, h)
    return _mlp_part(p, x, cfg, h), None


def apply_stack(stack: list, x: torch.Tensor, ctx: dict, cfg,
                cache: Optional[dict], mode: str, remat: bool = False):
    """Run every layer; ``mode`` is ``train`` (no cache: the training
    forward), ``prefill`` (fills a contiguous cache when one is given),
    ``decode`` (a contiguous cache, batch or per-slot; its ``slot_pos``
    already holds the step's position, ``decode_slot_pos``),
    ``decode_paged``, ``chunk`` or ``chunks`` (the paged cache, dense and
    MoE layers only).  ``ctx`` carries ``positions`` (and ``enc_out``, the
    encoder memory, for ``cross`` layers) in the sequence modes, the
    step's ``pos`` and the cache's bookkeeping in the others.  Caches are
    updated in place.  ``remat`` (train only) recomputes each layer of the
    scanned groups in the backward pass instead of keeping its
    activations (``stack_pattern``'s prefix and tail layers keep theirs).  Returns (hidden
    states, aux): the MoE layers' ``moe_aux_loss`` and ``moe_drop_frac``
    summed over the layers, as the reference's ``apply_stack``; 0.0 for a
    stack without MoE layers."""
    if mode == "train" and cache is not None:
        raise ValueError("mode='train' takes no cache")
    aux = {"moe_aux_loss": 0.0, "moe_drop_frac": 0.0}
    pat, n, prefix, _ = stack_pattern(cfg)
    scanned = range(len(prefix), len(prefix) + n * len(pat))
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), stack)):
        lc = cache["layers"][i] if cache is not None else None
        if remat and mode == "train" and i in scanned:
            x, a = checkpoint(shctx.under_current(_apply_layer), kind, p, x,
                              ctx, cfg, lc, mode, use_reentrant=False)
        else:
            x, a = _apply_layer(kind, p, x, ctx, cfg, lc, mode)
        if a is not None:
            aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def prefill_chunk_paged(stack: list, x: torch.Tensor,
                        positions: torch.Tensor, table_row: torch.Tensor,
                        cfg, cache: dict, use_kernels: bool):
    """Run ONE prompt chunk through the stack against the paged cache.

    x (1, T, D) embedded chunk; positions (T,) i32 its absolute positions
    ``ctx_len .. ctx_len + T - 1``; table_row (nb,) i32.  Every layer
    scatters the chunk's K/V into its page pools (in place) and attends
    full over the prefix, causal within the chunk.  Returns (hidden
    states, aux) as ``apply_stack``; the caller (``model.prefill_chunk``)
    owns the final norm, logits and ``pos``."""
    ctx = {"positions": positions, "table_row": table_row,
           "use_kernels": use_kernels, "rope": cache.get("rope")}
    return apply_stack(stack, x, ctx, cfg, cache, "chunk")
