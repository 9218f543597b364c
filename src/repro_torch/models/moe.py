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

Under a sharding policy ``apply_moe`` takes the reference's
expert-parallel path, ``apply_moe_ep``: what the reference computes inside
``shard_map`` runs on each rank's local shards, with the reference's
collectives as ``torch.distributed`` calls on the mesh's groups.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..sharding import context as shctx
from ..sharding import local as shlocal
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
    """Dispatcher, as the reference's: the expert-parallel path when a
    sharding policy is active (distributed runs), the single-device path
    otherwise."""
    policy = shctx.current()
    if policy is not None:
        return apply_moe_ep(params, x, cfg, policy)
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

    me = probs.mean(dim=0)
    ce = counts.float() / T
    load_balance = E * torch.sum(me * ce) / K
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"moe_aux_loss": cfg.router_aux_weight * load_balance
           + cfg.router_z_weight * z_loss,
           "moe_drop_frac": 1.0 - keep.sum() / (T * K)}
    # the shared expert last, as in the expert-parallel path: a remat's
    # recompute then stops before its down projection, whose output the
    # backward does not need
    if cfg.num_shared_experts:
        out = out + layers.apply_mlp(params["shared"], xt, "swiglu")
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# expert-parallel path
# ---------------------------------------------------------------------------
#
# Activation layout: x is sharded over the batch axes ("pod", "data") and
# replicated over "model"; expert weights are sharded E -> "model" and, in
# the train layout, d_model over the data axes ("fsdp"), in the serving
# layout d_ff over them ("expert_ff").  Because x is replicated over
# "model", each expert owner gathers its tokens locally and dispatch needs
# no all-to-all; the only exchanges are the gather of the weights' data
# shards (train layout) and one sum over "model" of the combined output.
# When E does not divide the model axis (mixtral's 8 experts on a wider
# axis) every model shard keeps all E experts and the expert d_ff is split
# instead ("mlp"); the same closing sum then completes the partial w_down
# contraction.  In the serving layout a small token set (decode) is
# gathered instead of the weights, and one sum over "model" and the data
# axes closes both partial sums.


def _axes_tuple(r) -> tuple:
    if r is None:
        return ()
    return (r,) if isinstance(r, str) else tuple(r)


def _expert_pass(xt, router, wg, wu, wd, cfg, e0: int, E_loc: int, C: int):
    """The reference's shard_map body on local tensors: route the (T, D)
    tokens over all E experts, dispatch the pairs that fall on experts
    e0..e0+E_loc-1 (at most C an expert), run those experts, and combine
    in float32, each token's pairs summed in sorted (expert id) order.
    Returns (out (T, D) f32, partial over the other expert shards, router
    logits, probs, the top-k ids, valid, keep)."""
    T, D = xt.shape
    K = cfg.experts_per_token
    logits, probs, top_p, top_e = route({"router": router}, xt, cfg)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // K
    sorted_w = top_p.reshape(-1)[order]
    local_e = sorted_e - e0
    valid = (local_e >= 0) & (local_e < E_loc)
    experts = torch.arange(E_loc, device=xt.device, dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e, e0 + experts)
    rank = (torch.arange(T * K, device=xt.device)
            - seg_start[torch.clamp(local_e, 0, E_loc - 1)])
    keep = valid & (rank < C)
    slot = torch.where(keep, local_e * C + rank, E_loc * C)
    xe = xt.new_zeros((E_loc * C + 1, D))
    xe = xe.index_copy(0, slot, xt[sorted_tok] * keep[:, None].to(xt.dtype))
    xe = xe[:E_loc * C].reshape(E_loc, C, D)
    h = F.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd).reshape(E_loc * C, D)
    contrib = (ye[torch.where(keep, slot, 0)]
               * (sorted_w * keep).to(xt.dtype)[:, None]).float()
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=xt.device)
    parts = contrib[torch.sort(inv.reshape(T, K), dim=1).values]
    out = parts[:, 0]
    for j in range(1, K):
        out = out + parts[:, j]
    return out, logits, probs, top_e, valid, keep


def apply_moe_ep(params: dict, x: torch.Tensor, cfg, policy):
    """The expert-parallel MoE layer (the reference's ``apply_moe_ep``)
    on DTensors laid out by ``policy``: x (B, S, D) -> (out, aux) as
    ``apply_moe_local``.  Each rank routes its own tokens (the whole token
    set in the serving layout's token-replicated decode, which takes no
    gradient) over every expert, runs the experts it holds
    (``experts_sharded``: E divides "model"; else a slice of every
    expert's d_ff), and one sum over "model" (``dist.all_reduce`` on
    ``mesh.get_group("model")``) closes the output.  The aux load-balance
    rates are averaged over the batch axes before their product, as the
    reference does."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = policy.mesh
    sizes = policy.axes
    names = list(sizes)
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    batch_axes = _axes_tuple(policy.resolve(B, "batch"))
    model_sz = sizes.get("model", 1)
    experts_sharded = E % model_sz == 0 and model_sz > 1
    E_loc = E // model_sz if experts_sharded else E
    T_loc = (B // math.prod(sizes[a] for a in batch_axes)) * S
    serving = policy.serving
    token_replicated = serving and B * S * K <= 32768
    C = _capacity(B * S if token_replicated else T_loc, cfg)
    coord = dict(zip(names, mesh.get_coordinate()))
    e0 = coord["model"] * E_loc if experts_sharded else 0

    x = policy.constrain(x, ("batch", None, None))
    wg_spec = policy.spec(params["w_gate"].shape, policy.moe_axes("gate_up"))
    wd_spec = policy.spec(params["w_down"].shape, policy.moe_axes("down"))
    wg = policy.constrain(params["w_gate"], policy.moe_axes("gate_up"))
    wu = policy.constrain(params["w_up"], policy.moe_axes("gate_up"))
    wd = policy.constrain(params["w_down"], policy.moe_axes("down"))
    router = policy.constrain(params["router"], (None, None))
    partial_out = [a for a in ("model",) if model_sz > 1]

    def grads_of_weight(w):
        # a weight's local gradient is partial over the axes whose ranks
        # see different tokens
        return [p if p.is_shard() else Partial() if a in batch_axes
                else Replicate() for a, p in zip(names, w.placements)]

    if token_replicated:
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "the serving layout's token-replicated MoE path is for "
                "inference (no gradient)")
        xt = x.redistribute(mesh, [Replicate()] * len(names)).to_local()
        xt = xt.reshape(B * S, D)
        out_all, logits, probs, top_e, valid, keep = _expert_pass(
            xt, router.to_local(), wg.to_local(), wu.to_local(),
            wd.to_local(), cfg, e0, E_loc, C)
        # one reduction closes both partial sums: over "model" iff the
        # expert dim is split there, and over exactly the axes that split
        # d_ff (axes where the computation was identical hold replicas)
        f_axes = _axes_tuple(wg_spec[2])
        psum_axes = (("model",) if experts_sharded else ()) + f_axes
        out_all = shlocal.all_reduce(out_all, mesh, psum_axes)
        r0 = shlocal.local_range(x, 0)[0] * S
        out = out_all[r0:r0 + T_loc]
        T_seen = B * S
    else:
        # gather the weights' non-expert shard axes (train layout:
        # d_model; serving layout: d_ff)
        gath = set(_axes_tuple(wg_spec[2 if serving else 1])
                   + _axes_tuple(wd_spec[1 if serving else 2]))

        def gathered(w):
            w = w.redistribute(mesh, [Replicate() if a in gath else p
                                      for a, p in zip(names, w.placements)])
            return w.to_local(grad_placements=grads_of_weight(w))
        # x is replicated over "model": each model rank's output (and so
        # its gradient for x) is a partial sum
        xl = x.to_local(grad_placements=[
            p if p.is_shard() else Partial() if a in partial_out
            else Replicate() for a, p in zip(names, x.placements)])
        xt = xl.reshape(T_loc, D)
        # the router's gradient, like x's, is partial over "model" through
        # the combine weights; the aux losses below are the same on every
        # model rank, so they pass 1 / model_sz of their gradient each
        router_l = router.to_local(grad_placements=[
            Partial() if a in batch_axes or a in partial_out else p
            for a, p in zip(names, router.placements)])
        out, logits, probs, top_e, valid, keep = _expert_pass(
            xt, router_l, gathered(wg), gathered(wu), gathered(wd), cfg,
            e0, E_loc, C)
        out = shlocal.all_reduce(out, mesh, partial_out)
        logits = shlocal.scale_grad(logits, 1.0 / model_sz)
        probs = shlocal.scale_grad(probs, 1.0 / model_sz)
        T_seen = T_loc
    out = shlocal.wrap(out.to(x.dtype).reshape(-1, S, D), x)

    me = probs.mean(dim=0)
    # expert counts by a scatter of static shape (``bincount``'s size
    # depends on the data, which a shape-only dry run cannot know)
    idx = top_e.reshape(-1).long()
    ce = torch.zeros(E, dtype=torch.long, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx)).float() / T_seen
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    with torch.no_grad():
        n_drop = (valid & ~keep).sum().float()
        if model_sz > 1:
            n_drop = shlocal.all_reduce(
                n_drop, mesh, ["model"], "sum" if experts_sharded else "mean")
        n_drop = shlocal.all_reduce(n_drop, mesh, batch_axes, "mean")
    if not token_replicated:
        # the rates are averaged over the batch shards BEFORE their
        # product (the loss is bilinear in the global rates), and the
        # per-shard z loss is averaged; the load balance is then already
        # the same on every rank and is not reduced again
        me = shlocal.all_reduce(me, mesh, batch_axes, "mean")
        ce = shlocal.all_reduce(ce, mesh, batch_axes, "mean")
        z_loss = shlocal.all_reduce(z_loss, mesh, batch_axes, "mean")
    load_balance = E * torch.sum(me * ce) / K
    # the losses are the same on every rank: replicated DTensors, so
    # autograd carries their gradient back into the local pass
    rep = [Replicate()] * len(names)
    aux = {"moe_aux_loss": shlocal.wrap(cfg.router_aux_weight * load_balance
                                        + cfg.router_z_weight * z_loss,
                                        x, rep),
           "moe_drop_frac": shlocal.wrap(n_drop / (T_seen * K), x, rep)}
    if cfg.num_shared_experts:
        out = out + layers.apply_mlp(params["shared"], x.reshape(B * S, D),
                                     "swiglu").reshape(B, S, D)
    return out, aux
