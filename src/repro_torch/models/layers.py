"""Dense neural building blocks (PyTorch port of ``repro.models.layers``).

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
  * ``embed`` multiplies by sqrt(D) in the parameter dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the model's RMSNorm is the RMSNorm kernel's plain version (one
# implementation; the reference keeps two identical ones)
from ..kernels.ref import rms_norm_ref as rms_norm  # noqa: F401

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, device,
               scale: float = 0.02) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, kv_positions: torch.Tensor,
                      causal: bool = True,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style attention, online softmax over ``kv_chunk`` key blocks
    exactly as the reference: q (B, Sq, H, D); k, v (B, Sk, KV, D) with
    GQA H = KV * G; q_positions (Sq,), kv_positions (Sk,).  Query blocks
    are independent, so the reference's query chunking is not repeated.
    Returns (B, Sq, H, D) in q's dtype."""
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
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= q_positions[:, None]
        s = torch.where(mask, s, NEG_INF)
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, q_position: torch.Tensor,
                     kv_positions: torch.Tensor, valid_len: torch.Tensor
                     ) -> torch.Tensor:
    """Single-step attention against a cache, consumed at its KV width.

    q: (B, 1, H, D); caches: (B, Smax, KV, D).  Batch form: scalar
    ``q_position``/``valid_len`` and (Smax,) ``kv_positions``; per-slot
    form: (B,) positions and lengths and (B, Smax) ``kv_positions``.
    """
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
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
    else:
        mask = (idx < valid_len) & (kv_positions <= q_pos)
        s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
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
    x = params["embedding"][tokens.long()]
    # sqrt(D) rounded to the parameter dtype first, as the reference's
    # ``jnp.asarray(sqrt(D), x.dtype)``; kept a host scalar (no copy)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
    return x * scale


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
