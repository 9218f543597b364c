"""Plain float32 reference of the dense and MoE decoders the cells serve.

Straight PyTorch, no kernel, no cache, no batching tricks, and nothing of
the program imported: the full causal forward pass of each sequence, as
the configuration file's ``model`` sizes describe it.

  * embedding rows times sqrt(D); RMSNorm in float32, scaled by (1 + w);
  * attention: q, k, v projections, RoPE rotating the two halves of each
    head at the positions 0.. of the sequence, GQA (each KV head serves
    H / KV query heads), causal softmax at 1/sqrt(head_dim), output
    projection; a residual add;
  * MLP: tanh GELU, or SwiGLU (silu(x Wg) * x Wu) Wd; a residual add;
  * MoE: float32 router, softmax over every expert, the top k (ties to the
    lower id) renormalised, each chosen expert's SwiGLU weighted and
    summed, plus the shared expert;
  * final RMSNorm, logits against the (tied) embedding or the head, the
    padded vocabulary rows masked.

Weights are the bf16 tensors both sides were given, upcast to float32 one
layer (and for the routed experts, one group of experts) at a time, so
that the reference fits beside them.  TF32 is off while it runs.

``quant="fp8"`` is the control: every product with a weight takes its
weight rounded to float8 e4m3 per output column and its activation
rounded per row, the precision one step below the configuration's bf16.

The MoE layer keeps every (token, expert) choice of the last layer apart
(``Forward.parts``), so that a caller can form the hidden state with any
of them left out: the program drops a choice past an expert's capacity,
which depends on what else shared the dispatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

_F8_MAX = 448.0
# routed experts upcast together
EXPERT_GROUP = 32
# vocabulary rows of the head upcast together
VOCAB_BLOCK = 16384


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions while the reference
    runs; the previous settings restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def _f8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``'s complement (the amax over ``dim`` maps to 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / _F8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Math:
    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def w(self, t: torch.Tensor, contract: int = 0) -> torch.Tensor:
        """A weight upcast to float32 (and rounded, for the control) over
        its contraction axis ``contract``."""
        t = t.float()
        return _f8(t, contract) if self.quant else t

    def a(self, x: torch.Tensor) -> torch.Tensor:
        return _f8(x, -1) if self.quant else x


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def rope(x, pos, theta):
    """x (B, L, H, hd) float32 rotated at positions ``pos`` (L,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, model, m: _Math):
    B, L, D = h.shape
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    ha = m.a(h)
    q = torch.einsum("bld,dhk->blhk", ha, m.w(p["wq"]))
    k = torch.einsum("bld,dhk->blhk", ha, m.w(p["wk"]))
    v = torch.einsum("bld,dhk->blhk", ha, m.w(p["wv"]))
    pos = torch.arange(L, device=h.device)
    q, k = rope(q, pos, model["rope_theta"]), rope(k, pos, model["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(hd)
    causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqs,bshk->bqhk", torch.softmax(s, dim=-1), v)
    wo = m.w(p["wo"].reshape(H * hd, D)).reshape(H, hd, D)
    return torch.einsum("blhk,hkd->bld", m.a(o.reshape(B, L, H * hd)).reshape(
        B, L, H, hd), wo)


def mlp(p, h, act, m: _Math):
    ha = m.a(h)
    up = ha @ m.w(p["w_up"])
    if act == "swiglu":
        z = F.silu(ha @ m.w(p["w_gate"])) * up
    else:
        z = F.gelu(up, approximate="tanh")
    return m.a(z) @ m.w(p["w_down"])


def route(router, h, k):
    """Top-k experts of each row of h (T, D): renormalised weights and
    ids, ties to the lower id (a stable descending sort)."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return top_p / top_p.sum(-1, keepdim=True), top_e


def moe_parts(p, h, model, m: _Math):
    """h (T, D) -> (each row's k weighted expert outputs (T, k, D), the
    shared expert's output (T, D), the expert ids (T, k))."""
    T, D = h.shape
    K, E = model["experts_per_token"], model["num_experts"]
    w, e = route(p["router"], h, K)
    parts = torch.zeros(T, K, D, dtype=torch.float32, device=h.device)
    ha = m.a(h)
    for g0 in range(0, E, EXPERT_GROUP):
        g1 = min(E, g0 + EXPERT_GROUP)
        sel = (e >= g0) & (e < g1)
        if not bool(sel.any()):
            continue
        wg = m.w(p["w_gate"][g0:g1], 1)
        wu = m.w(p["w_up"][g0:g1], 1)
        wd = m.w(p["w_down"][g0:g1], 1)
        for x in range(g0, g1):
            rows, slot = torch.nonzero(e == x, as_tuple=True)
            if rows.numel() == 0:
                continue
            z = F.silu(ha[rows] @ wg[x - g0]) * (ha[rows] @ wu[x - g0])
            parts[rows, slot] = (m.a(z) @ wd[x - g0]) * w[rows, slot, None]
        del wg, wu, wd
    shared = (mlp(p["shared"], h, "swiglu", m) if "shared" in p
              else torch.zeros_like(h))
    return parts, shared, e


@dataclasses.dataclass
class Forward:
    """The last layer's input to the final norm: ``base`` (T, D) plus,
    for a MoE last layer, the sum of ``parts`` (T, k, D) over the kept
    choices; ``experts`` (T, k) their ids.  Rows are the flattened
    (sequence, position) pairs of the padded batch."""
    base: torch.Tensor
    parts: Optional[torch.Tensor]
    experts: Optional[torch.Tensor]

    def hidden(self, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The final hidden rows with the choices ``keep`` (T, k) bool
        (all when None)."""
        if self.parts is None:
            return self.base
        if keep is None:
            return self.base + self.parts.sum(1)
        return self.base + (self.parts * keep[..., None]).sum(1)


def kinds(model: dict) -> List[str]:
    if model["family"] == "moe":
        k = model["num_dense_layers"]
        return ["dense"] * k + ["moe"] * (model["num_layers"] - k)
    return ["dense"] * model["num_layers"]


@torch.no_grad()
def forward(weights: dict, model: dict, tokens: torch.Tensor,
            quant: Optional[str] = None) -> Forward:
    """tokens (B, L) int64 -> the last layer's ``Forward`` over its
    B * L rows."""
    m = _Math(quant)
    B, L = tokens.shape
    D = model["d_model"]
    eps = model["norm_eps"]
    x = weights["embed"]["embedding"][tokens].float() * math.sqrt(D)
    layers = weights["layers"]
    kinds_ = kinds(model)
    out = None
    with exact_float32():
        for i, (kind, p) in enumerate(zip(kinds_, layers)):
            x = x + attention(p["attn"], rms_norm(x, p["ln1"], eps), model, m)
            h = rms_norm(x, p["ln2"], eps)
            if kind == "moe":
                parts, shared, e = moe_parts(p["moe"], h.reshape(B * L, D),
                                             model, m)
                base = x.reshape(B * L, D) + shared
                if i == len(layers) - 1:
                    out = Forward(base, parts, e)
                else:
                    x = (base + parts.sum(1)).reshape(B, L, D)
            else:
                x = x + mlp(p["mlp"], h, model["mlp_act"], m)
        if out is None:
            out = Forward(x.reshape(B * L, D), None, None)
    return out


@torch.no_grad()
def logit_stats(weights: dict, model: dict, hidden: torch.Tensor,
                tokens: torch.Tensor, quant: Optional[str] = None):
    """For each row of ``hidden`` (N, D): the largest logit over the
    vocabulary, the logit of ``tokens`` (N,), and the argmax id.  The
    head is read in blocks of ``VOCAB_BLOCK`` rows."""
    m = _Math(quant)
    V = model["vocab_size"]
    h = m.a(rms_norm(hidden, weights["final_ln"], model["norm_eps"]))
    emb = weights["embed"]
    best = torch.full((h.shape[0],), float("-inf"), device=h.device)
    arg = torch.zeros(h.shape[0], dtype=torch.long, device=h.device)
    mine = torch.zeros(h.shape[0], device=h.device)
    with exact_float32():
        for v0 in range(0, V, VOCAB_BLOCK):
            v1 = min(V, v0 + VOCAB_BLOCK)
            if model["tie_embeddings"]:
                head = m.w(emb["embedding"][v0:v1], 1).t()
            else:
                head = m.w(emb["lm_head"][:, v0:v1], 0)
            lg = h @ head
            bm, ba = lg.max(dim=1)
            better = bm > best
            best = torch.where(better, bm, best)
            arg = torch.where(better, ba + v0, arg)
            inside = (tokens >= v0) & (tokens < v1)
            idx = (tokens - v0).clamp(0, v1 - v0 - 1)
            mine = torch.where(inside, lg.gather(1, idx[:, None])[:, 0], mine)
    mine = torch.where((tokens >= 0) & (tokens < V), mine,
                       torch.full_like(mine, float("-inf")))
    return best, mine, arg
