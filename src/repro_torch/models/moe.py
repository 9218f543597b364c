"""Mixture-of-Experts layer (PyTorch port of ``repro.models.moe``).

A float32 top-k router and the reference's sort-based capacity dispatch,
step for step: the (token, choice) pairs are sorted by expert id (stably,
so within an expert tokens keep their order), each pair's rank within its
expert decides whether it fits the capacity ``C``, the kept tokens are
placed in an ``(E, C, D)`` buffer, every expert runs its SwiGLU over its
``C`` rows as one batched product, and the outputs are combined with the
renormalised router weights, plus the shared expert.

Every step runs on the device and reads nothing back on the host, so a
CUDA graph captures the layer (the engine's decode windows and fused
prefill).  The capacity follows the token count of the tensor the layer
is given, as in the reference: the fused prefill routes its whole padded
packed stream, so padding rows take capacity too.

The expert-parallel path of the reference (``apply_moe_ep``) needs a
sharding policy, which the port does not have yet (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers


def init_moe(generator, cfg, dtype, device) -> dict:
    """Router (D, E) in float32, expert stacks ``w_gate``/``w_up``
    (E, D, F) and ``w_down`` (E, F, D) in ``dtype``, and the shared
    experts as one SwiGLU MLP of width ``F * num_shared_experts``."""
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "router": layers.dense_init(generator, (D, E), torch.float32, device),
        "w_gate": layers.dense_init(generator, (E, D, Fe), dtype, device),
        "w_up": layers.dense_init(generator, (E, D, Fe), dtype, device),
        "w_down": layers.dense_init(generator, (E, Fe, D), dtype, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.init_mlp(generator, D,
                                      Fe * cfg.num_shared_experts, "swiglu",
                                      dtype, device)
    return p


def _capacity(num_tokens: int, cfg) -> int:
    cap = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
              / cfg.num_experts)
    return max(8, -(-cap // 8) * 8)


def apply_moe(params: dict, x: torch.Tensor, cfg):
    """The MoE layer as the model calls it: the single-device path.  The
    reference's expert-parallel path under a sharding policy comes with
    the port's sharding layer (ROADMAP Queue 1 item 10)."""
    return apply_moe_local(params, x, cfg)


def route(params: dict, xt: torch.Tensor, cfg):
    """Router logits (T, E) f32, probabilities, and the top-k choices:
    weights renormalised over the k, expert ids (T, k).  ``lax.top_k``
    orders by value with ties to the lower id; a stable descending sort
    gives exactly that order (``torch.topk`` does not promise one)."""
    logits = xt.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    return logits, probs, top_p / top_p.sum(-1, keepdim=True), top_e


def dispatch(top_e: torch.Tensor, C: int, E: int):
    """The sort-based dispatch plan of the flattened (T*k,) choices:
    ``order`` (the stable sort by expert id), each sorted pair's
    ``rank`` within its expert, ``keep = rank < C``, its row ``slot`` of
    the (E*C, D) buffer (dropped pairs get row E*C, the spare one), and
    the tokens each expert was chosen by, ``counts`` (E,)."""
    flat_e = top_e.reshape(-1)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(E, device=top_e.device, dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - seg_start
    rank = torch.arange(n, device=top_e.device) - seg_start[sorted_e]
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)
    return order, sorted_e, keep, slot, counts


def apply_moe_local(params: dict, x: torch.Tensor, cfg):
    """x (B, S, D) -> (out (B, S, D), aux): the load-balance plus z loss
    (``moe_aux_loss``) and the share of dropped choices
    (``moe_drop_frac``), both 0-d float32 tensors on the device."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = _capacity(T, cfg)
    xt = x.reshape(T, D)
    logits, probs, top_p, top_e = route(params, xt, cfg)
    order, _, keep, slot, counts = dispatch(top_e, C, E)
    sorted_tok = order // K
    sorted_w = top_p.reshape(-1)[order]

    # one spare row takes every dropped choice (the reference drops them
    # with an out-of-range scatter) and is cut off
    xe = x.new_zeros((E * C + 1, D))
    xe.index_copy_(0, slot, xt[sorted_tok] * keep[:, None].to(x.dtype))
    xe = xe[:E * C].reshape(E, C, D)
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(
        xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"]).reshape(E * C, D)
    contrib = ye[torch.where(keep, slot, 0)] * \
        (sorted_w * keep).to(x.dtype)[:, None]

    # The reference adds the contributions into zeros with a scatter-add
    # in sorted order, that is by ascending expert id within each token.
    # Here each token's k contributions are gathered in that order and
    # summed left to right in x's dtype: the same order on every run,
    # where an atomic scatter-add on the card would sum in any order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=x.device)
    per_tok = torch.sort(inv.reshape(T, K), dim=1).values
    parts = contrib[per_tok]                               # (T, K, D)
    out = parts[:, 0]
    for j in range(1, K):
        out = out + parts[:, j]
    if cfg.num_shared_experts:
        out = out + layers.apply_mlp(params["shared"], xt, "swiglu")

    me = probs.mean(dim=0)
    ce = counts.float() / T
    load_balance = E * torch.sum(me * ce) / K
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"moe_aux_loss": cfg.router_aux_weight * load_balance
           + cfg.router_z_weight * z_loss,
           "moe_drop_frac": 1.0 - keep.sum() / (T * K)}
    return out.reshape(B, S, D), aux
