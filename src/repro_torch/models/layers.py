"""Neural building blocks (PyTorch port of ``repro.models.layers``).

Parameters are plain dicts of tensors in the reference's layouts (``wq``
(D, H, hd), ``wo`` (H, hd, D), ``embedding`` (V, D), ...), so the weight
bridge in ``convert.py`` is a copy.  Every function reproduces the
reference's casts, because the engine's greedy tokens on the CPU are held
against the JAX engine's:

  * ``rms_norm`` reduces in float32 and scales by ``(1 + w)``;
  * ``apply_rope`` rotates the two halves of the head dimension in float32;
  * the attention paths take scores in float32 and cast the probabilities
    to the value dtype before the P·V product (bf16 pages make that a
    rounding step the reference has too);
  * ``apply_mlp`` uses the tanh GELU, ``jax.nn.gelu``'s default;
  * ``gated_rms_norm`` takes the gate's SiLU in float32 and casts it to
    x's dtype before the product;
  * ``embed`` multiplies by sqrt(D) in the parameter dtype.

Under a sharding policy (``repro_torch.sharding``) the tensors are
DTensors and the reference's constraint sites redistribute them: the
query layout of ``attention_qkv`` (``policy.attn_q_axes``), K/V by kv
heads, and the expanded K/V of the attention paths by heads.  The
attention cores then run on each rank's shards (``_on_shards``), as they
need no communication; decode against a sequence-sharded cache (kv heads
that do not divide "model") closes its softmax over the sequence shards
with three small all-reduces, where GSPMD reduces the reference's
``kv_seq`` score row.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the model's RMSNorm is the RMSNorm kernel's plain version (one
# implementation; the reference keeps two identical ones)
from ..kernels.ref import rms_norm_ref as rms_norm  # noqa: F401
from ..sharding import context as shctx
from ..sharding import local as shlocal

NEG_INF = -1e30


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba-2's norm, ``rms_norm(x * silu(z))``: the gate in float32,
    cast to x's dtype before the product, as the reference."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), weight, eps)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


# float32 draws of a larger tensor are made a leading-axis slice at a time:
# one MoE expert stack of kimi-k2 is 5.6 GB in bf16 and would take a
# 22.5 GB float32 temporary drawn whole
_INIT_SLICE_BYTES = 2**30


def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: float = 0.02) -> torch.Tensor:
    """``scale`` times standard normal float32 draws, cast to ``dtype``."""
    shape = tuple(shape)
    if (4 * torch.Size(shape).numel() <= _INIT_SLICE_BYTES
            or torch.device(device).type == "meta"):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, _INIT_SLICE_BYTES // (4 * out[0].numel()))
    for lo in range(0, shape[0], step):
        part = out[lo:lo + step]
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=device, dtype=torch.float32) * scale)
    return out


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # float32 throughout; a Python scalar base needs no host-to-device
    # copy (a blocking copy here would drain the launch queue per layer)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    angles = angles[..., None, :]                          # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (plain PyTorch; the CUDA kernels live in repro_torch.kernels)
# ---------------------------------------------------------------------------


def expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D): each KV head repeated G times."""
    KV = k.shape[2]
    if KV == num_heads:
        return k
    return torch.repeat_interleave(k, num_heads // KV, dim=2)


def _window_mask(q_positions, kv_positions, causal: bool,
                 window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) mask of the keys each query sees: causal keys, and with a
    ``window`` only those less than ``window`` positions back (the
    reference's ``_attend_chunk``)."""
    mask = torch.ones((q_positions.shape[0], kv_positions.shape[0]),
                      dtype=torch.bool, device=q_positions.device)
    if causal:
        mask &= kv_positions[None, :] <= q_positions[:, None]
    if window is not None:
        mask &= (q_positions[:, None] - kv_positions[None, :]) < window
    return mask


def _on_shards(core, q, k, v, q_axes, q_positions, **kw):
    """``core`` (an attention path) on this rank's shards of DTensors q,
    k, v: q laid out by ``q_axes`` (batch, then heads or sequence), K/V by
    batch and kv heads, expanded here to the query heads the rank holds
    (the reference's ``("batch", None, "heads", None)`` constraint of the
    expanded K/V, taken locally); ``q_positions`` cut to the rank's query
    rows.  K/V gradients are partial over the mesh axes that split the
    queries but not K/V.  Returns the output laid out as q."""
    from torch.distributed.tensor import Partial
    policy = shctx.current()
    H = q.shape[2]
    G = H // k.shape[2]
    q = policy.constrain(q, q_axes)
    kv_axes = ("batch", None, "kv_heads", None)
    k, v = policy.constrain(k, kv_axes), policy.constrain(v, kv_axes)
    grads = [pk if pk.is_shard() else Partial() if pq.is_shard() else pk
             for pk, pq in zip(k.placements, q.placements)]
    h0, hn = shlocal.local_range(q, 2)
    g0 = shlocal.local_range(k, 2)[0] * G
    s0, sn = shlocal.local_range(q, 1)

    def heads(t):
        t = t.to_local(grad_placements=grads)
        t = expand_kv(t, t.shape[2] * G)
        return t[:, :, h0 - g0:h0 - g0 + hn]
    out = core(q.to_local(), heads(k), heads(v),
               q_positions=q_positions[s0:s0 + sn], **kw)
    return shlocal.wrap(out, q)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention, online softmax over ``kv_chunk`` key blocks
    exactly as the reference: q (B, Sq, H, D); k, v (B, Sk, KV, D) with
    GQA H = KV * G; q_positions (Sq,), kv_positions (Sk,); ``window``
    keeps only keys with ``q_pos - k_pos < window``.  Query blocks are
    independent, so the reference's query chunking is not repeated.
    Returns (B, Sq, H, D) in q's dtype.  Under a policy q keeps its layout
    (``attn_q_axes``: a sequence-sharded q is never chunked over, the
    reference's transformer.py:154) and each rank attends its shards."""
    policy = shctx.current()
    if policy is not None and shlocal.is_dtensor(q):
        return _on_shards(chunked_attention, q, k, v,
                          policy.attn_q_axes(q.shape[1], q.shape[2]),
                          q_positions, kv_positions=kv_positions,
                          causal=causal, window=window, kv_chunk=kv_chunk)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    k = expand_kv(k, H)
    v = expand_kv(v, H)
    kv_chunk = min(kv_chunk, Sk)
    qf = q.float()
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for lo in range(0, Sk, kv_chunk):
        ki = k[:, lo:lo + kv_chunk]
        vi = v[:, lo:lo + kv_chunk]
        kpos = kv_positions[lo:lo + kv_chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, ki.float()) * scale
        s = torch.where(_window_mask(q_positions, kpos, causal, window), s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(vi.dtype).float(),
                          vi.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).permute(0, 2, 1, 3)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       q_positions: torch.Tensor, kv_positions: torch.Tensor,
                       window: int, q_chunk: int = 1024) -> torch.Tensor:
    """Sliding-window causal attention in O(S * window), the reference's
    scheme: queries in chunks of ``q_chunk``, each against the key span
    ``[chunk_start - window, chunk_end)``.  K/V are left-padded by
    ``window`` rows at position -2^30 (never inside a window) and
    right-padded with the queries at +2^30 (never causal).  Prefill only
    (q and K/V aligned, Sq == Sk); a window of at least Sk is full causal
    attention, which ``chunked_attention`` computes as the reference does.
    Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if window >= Sk:
        return chunked_attention(q, k, v, q_positions=q_positions,
                                 kv_positions=kv_positions, causal=True,
                                 window=window)
    scale = 1.0 / (D ** 0.5)
    k = expand_kv(k, H)
    v = expand_kv(v, H)
    q_chunk = min(q_chunk, Sq)
    nq = -(-Sq // q_chunk)
    pq = nq * q_chunk - Sq
    dev = q.device
    q = F.pad(q, (0, 0, 0, 0, 0, pq))
    q_positions = torch.cat([q_positions.to(torch.int32), torch.full(
        (pq,), -1, dtype=torch.int32, device=dev)])
    k = F.pad(k, (0, 0, 0, 0, window, pq))
    v = F.pad(v, (0, 0, 0, 0, window, pq))
    kv_positions = torch.cat([
        torch.full((window,), -(2**30), dtype=torch.int32, device=dev),
        kv_positions.to(torch.int32),
        torch.full((pq,), 2**30, dtype=torch.int32, device=dev)])
    span = window + q_chunk
    outs = []
    for lo in range(0, nq * q_chunk, q_chunk):
        qpi = q_positions[lo:lo + q_chunk]
        ki, vi = k[:, lo:lo + span], v[:, lo:lo + span]
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:lo + q_chunk].float(),
                         ki.float()) * scale
        s = torch.where(_window_mask(qpi, kv_positions[lo:lo + span], True,
                                     window), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bhqd", p.to(vi.dtype).float(),
                                 vi.float()).to(q.dtype))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_position: torch.Tensor,
                     kv_positions: torch.Tensor, valid_len: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-step attention against a cache, consumed at its KV width.

    q: (B, 1, H, D); caches: (B, Smax, KV, D).  Batch form: scalar
    ``q_position``/``valid_len`` and (Smax,) ``kv_positions``; per-slot
    form: (B,) positions and lengths and (B, Smax) ``kv_positions``.
    ``window`` keeps only keys with ``q_pos - k_pos < window``.

    Under a policy the cache is a DTensor and each rank attends its
    shards: by kv heads where they divide "model", else by sequence
    (``_decode_seq_sharded``).
    """
    policy = shctx.current()
    if policy is not None and shlocal.is_dtensor(k_cache):
        return _decode_on_shards(policy, q, k_cache, v_cache,
                                 q_position=q_position,
                                 kv_positions=kv_positions,
                                 valid_len=valid_len, window=window)
    B, _, H, D = q.shape
    Sm, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / (D ** 0.5)
    qr = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) * scale
    idx = torch.arange(Sm, device=q.device)
    q_pos = torch.as_tensor(q_position, device=q.device)
    valid_len = torch.as_tensor(valid_len, device=q.device)
    if q_pos.ndim:                          # per-slot decode: (B,) state
        mask = ((idx[None, :] < valid_len[:, None])
                & (kv_positions <= q_pos[:, None]))
        if window is not None:
            mask &= (q_pos[:, None] - kv_positions) < window
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    else:
        mask = (idx < valid_len) & (kv_positions <= q_pos)
        if window is not None:
            mask &= (q_pos - kv_positions) < window
        s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def _decode_on_shards(policy, q, k_cache, v_cache, *, q_position,
                      kv_positions, valid_len, window):
    """``decode_attention`` on this rank's shards of a DTensor cache laid
    out by ``policy.cache_shardings``."""
    KV = k_cache.shape[2]
    per_row = torch.as_tensor(q_position).ndim > 0
    b0, bn = shlocal.local_range(k_cache, 0)

    def rows(t):
        t = torch.as_tensor(t)
        return t[b0:b0 + bn] if per_row else t

    kv_split = policy.resolve(KV, "kv_heads") is not None
    # the cache is stored sequence-sharded where kv heads don't divide the
    # model axis: the query row is then replicated over "model" and the
    # score row stays split by sequence (the reference's "kv_seq")
    q = policy.constrain(q, ("batch", None, "heads" if kv_split else None,
                             None))
    if kv_split or not shlocal.shard_axes(k_cache, 1):
        out = decode_attention(q.to_local(), k_cache.to_local(),
                               v_cache.to_local(),
                               q_position=rows(q_position),
                               kv_positions=rows(kv_positions),
                               valid_len=rows(valid_len), window=window)
    else:
        out = _decode_seq_sharded(q.to_local(), k_cache, v_cache,
                                  q_position=rows(q_position),
                                  kv_positions=rows(kv_positions),
                                  valid_len=rows(valid_len), window=window)
    return shlocal.wrap(out, q)


def _decode_seq_sharded(q, k_cache, v_cache, *, q_position, kv_positions,
                        valid_len, window):
    """One query a row against this rank's sequence slice of the cache:
    local scores, then the softmax's max and sum and the P·V product
    closed over the sequence shards (``all_reduce`` on the mesh axes that
    split the cache's sequence dim), with the reference's order of
    operations: p = exp(s - max) / sum, cast to the value dtype, then
    P·V."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    s0, sn = shlocal.local_range(k_cache, 1)
    mesh, axes = k_cache.device_mesh, shlocal.shard_axes(k_cache, 1)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    scale = 1.0 / (D ** 0.5)
    qr = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, kl.float()) * scale
    idx = torch.arange(s0, s0 + sn, device=q.device)
    q_pos = torch.as_tensor(q_position, device=q.device)
    valid_len = torch.as_tensor(valid_len, device=q.device)
    kv_pos = kv_positions[..., s0:s0 + sn]
    if q_pos.ndim:
        mask = ((idx[None, :] < valid_len[:, None])
                & (kv_pos <= q_pos[:, None]))
        if window is not None:
            mask &= (q_pos[:, None] - kv_pos) < window
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    else:
        mask = (idx < valid_len) & (kv_pos <= q_pos)
        if window is not None:
            mask &= (q_pos - kv_pos) < window
        s = torch.where(mask[None, None, None, :], s, NEG_INF)
    m = shlocal.all_reduce(s.amax(dim=-1, keepdim=True), mesh, axes, "max")
    e = torch.exp(s - m)
    p = e / shlocal.all_reduce(e.sum(dim=-1, keepdim=True), mesh, axes)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(vl.dtype).float(),
                       vl.float())
    out = shlocal.all_reduce(out, mesh, axes)
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (projections)
# ---------------------------------------------------------------------------


def init_attention(generator, cfg, dtype, device) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(generator, (D, H, hd), dtype, device),
        "wk": dense_init(generator, (D, KV, hd), dtype, device),
        "wv": dense_init(generator, (D, KV, hd), dtype, device),
        "wo": dense_init(generator, (H, hd, D), dtype, device),
    }


def attention_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                  rope_theta: float):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    policy = shctx.current()
    if policy is not None:
        q = policy.constrain(q, policy.attn_q_axes(q.shape[1], q.shape[2]))
    k = shctx.constrain(k, ("batch", None, "kv_heads", None))
    v = shctx.constrain(v, ("batch", None, "kv_heads", None))
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_out(params: dict, attn: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn, params["wo"])


# ---------------------------------------------------------------------------
# MLP / embedding / logits
# ---------------------------------------------------------------------------


def init_mlp(generator, d_model: int, d_ff: int, act: str, dtype,
             device) -> dict:
    p = {"w_up": dense_init(generator, (d_model, d_ff), dtype, device),
         "w_down": dense_init(generator, (d_ff, d_model), dtype, device)}
    if act == "swiglu":
        p["w_gate"] = dense_init(generator, (d_model, d_ff), dtype, device)
    return p


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        h = torch.relu(up)
    return h @ params["w_down"]


def init_embedding(generator, cfg, dtype, device) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    p = {"embedding": dense_init(generator, (V, D), dtype, device,
                                 scale=1.0 / (D ** 0.5))}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (D, V), dtype, device)
    return p


def embed(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    table = params["embedding"]
    if shlocal.is_dtensor(table):
        x = _embed_on_shards(shctx.current(), table, tokens)
    else:
        x = F.embedding(tokens.long(), table)
    # sqrt(D) rounded to the parameter dtype first, as the reference's
    # ``jnp.asarray(sqrt(D), x.dtype)``; kept a host scalar (no copy)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x * scale


def _embed_on_shards(policy, table, tokens):
    """The lookup of a DTensor table (vocab rows split over "model") on
    this rank's shards: each rank gathers the rows it holds, zeros the
    others, and one sum over the vocab axes completes every row (exact:
    one term is non-zero).  The result is laid out by the tokens' batch
    and replicated otherwise."""
    from torch.distributed.tensor import Partial, Replicate
    tok = policy.constrain(tokens, ("batch", None))
    v0, vn = shlocal.local_range(table, 0)
    local = tok.to_local().long() - v0
    inside = (local >= 0) & (local < vn)
    rows = table.to_local(grad_placements=[
        p if p.is_shard() else Partial() if pt.is_shard() else p
        for p, pt in zip(table.placements, tok.placements)])
    x = F.embedding(local.clamp(0, vn - 1), rows)
    x = shlocal.all_reduce(x * inside[..., None].to(x.dtype),
                           table.device_mesh, shlocal.shard_axes(table, 0))
    return shlocal.wrap(x, tok, [p if p.is_shard() else Replicate()
                                 for p in tok.placements])


def logits(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", x, params["embedding"])
    else:
        out = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    V = cfg.padded_vocab
    if V != cfg.vocab_size:
        mask = torch.arange(V, device=x.device) < cfg.vocab_size
        out = torch.where(mask, out, NEG_INF)
    return out
