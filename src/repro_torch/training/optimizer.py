"""Optimizers (PyTorch port of ``repro.training.optimizer``): AdamW and
Adafactor in the reference's functional (init, update) convention over the
port's parameter tree (nested dicts and lists of tensors):

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The update rules are the reference's step for step, in float32.  Unlike
the reference, the state's moments are updated in place and
``apply_updates`` adds into the parameters in place (the port's idiom;
for a 3 B model a second copy of the float32 moments would be 24 GB).
The update tree ``update`` returns is float32, as the reference's: 12 GB
at 3 B parameters until ``apply_updates`` has consumed it.

AdamW keeps two float32 moments per parameter.  Adafactor factors the
second moment of every large matrix into row and column statistics and
keeps no first moment.  Two of its rules look at a whole leaf of the
reference's tree, where the layers of a scanned group are one stacked
leaf: whether to factor (the last two dims of the stacked shape) and the
update clip, whose RMS runs over the stacked leaf, that is over every
layer of the group at once.  So the port's Adafactor takes the model's
``cfg`` and groups the per-layer leaves as the reference stacks them
(``convert.layer_groups``: the layers of each ``scan{s}`` together, prefix
and tail layers alone, the encoder's blocks together); it keeps its
statistics per group, in the reference's stacked shapes, keyed by the
reference's leaf path (``stack/scan0/attn/wq``).

On DTensor parameters (a sharded run) the gradients arrive laid out as
their parameters and the state as ``policy.opt_shardings`` lays it out;
every rule then runs on the local shards, since AdamW is elementwise, and
the reductions DTensor would need rules for close over the mesh axes
that split them (``sharding.local``): the global gradient norm (each
shard counted once), Adafactor's row and column means, the mean of its
row statistics and its update RMS.  The updates are DTensors laid out as
the parameters.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..models import convert
from ..sharding import local as shlocal
from ..tree import tree_get, tree_map, tree_paths, tree_set


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u`` in the parameter's dtype (``u`` cast first, as the
    reference), in place (on the local shards of DTensors); returns
    ``params``."""
    tree_map(lambda p, u: shlocal.local(p).add_(
        shlocal.local(u).to(p.dtype)), params, updates)
    return params


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares.  For
    DTensor leaves: each rank's sum over its shards, each shard counted on
    one rank of its replicas, summed over the ranks (a plain tensor)."""
    leaves = [leaf for _, leaf in tree_paths(tree)]
    if not any(shlocal.is_dtensor(leaf) for leaf in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in leaves))
    total = sum(torch.sum(torch.square(shlocal.local(leaf).float()))
                * shlocal.owner(leaf) for leaf in leaves)
    return torch.sqrt(shlocal.world_sum(total))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: shlocal.wrap(
        shlocal.local(g) * scale.to(g.dtype), g), grads), norm


def _first_leaf(tree) -> torch.Tensor:
    return tree_paths(tree)[0][1]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_first_leaf(params).device),
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = shlocal.local(state["step"])
        step += 1
        t = step.float()
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def one(g, mu, nu, p):
            like = p
            g, mu, nu, p = (shlocal.local(a) for a in (g, mu, nu, p))
            g = g.float()
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * torch.square(g))
            return shlocal.wrap(
                -lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                       + weight_decay * p.float()), like)

        return tree_map(one, grads, state["mu"], state["nu"], params), state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored second moment, no momentum
# ---------------------------------------------------------------------------


def reference_groups(params, cfg) -> list:
    """``(name, member paths, stacked)`` for every leaf of the reference's
    tree that ``params`` holds: the layers of a scanned group
    (``convert.layer_groups``) and the encoder's blocks are one stacked
    leaf each, named by the reference's path."""
    out = []
    for key, sub in params.items():
        if key == "layers":
            for gname, idx, stacked in convert.layer_groups(cfg):
                for rel, _ in tree_paths(sub[idx[0]]):
                    out.append(("/".join(("stack", gname) + rel),
                                [(key, i) + rel for i in idx], stacked))
        elif key == "encoder":
            blocks = sub["blocks"]
            for rel, _ in tree_paths(blocks[0]):
                out.append(("/".join(("encoder", "blocks") + rel),
                            [(key, "blocks", i) + rel
                             for i in range(len(blocks))], True))
            out.append(("encoder/final_ln", [(key, "final_ln")], False))
        else:
            out += [("/".join((key,) + rel), [(key,) + rel], False)
                    for rel, _ in tree_paths(sub)]
    return out


def _gather(tree, members: list, stacked: bool) -> torch.Tensor:
    """A group's leaves as the reference's one leaf (stacked along a new
    leading dim for a scanned group): the local shards of DTensors."""
    if stacked:
        return torch.stack([shlocal.local(tree_get(tree, m))
                            for m in members])
    return shlocal.local(tree_get(tree, members[0]))


def _group_layout(leaf, stacked: bool):
    """The placements of a group's stacked leaf (its members' shifted one
    dim right), None for plain leaves."""
    if not shlocal.is_dtensor(leaf):
        return None
    from torch.distributed.tensor import Shard
    return [Shard(p.dim + 1) if stacked and p.is_shard() else p
            for p in leaf.placements]


def _without(placements, dim: int, ndim: int):
    """``placements`` of a tensor whose dim ``dim`` (of ``ndim``) is
    reduced away."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= ndim
    return [p if not p.is_shard() else Replicate() if p.dim == dim
            else Shard(p.dim - (p.dim > dim)) for p in placements]


def _mean(x, like, dims, keepdim: bool = False):
    """``x.mean(dims)`` of a local shard laid out as DTensor ``like``
    (the plain mean for a plain ``like``)."""
    if like is None:
        return x.mean(dim=dims, keepdim=keepdim) if dims else x.mean()
    dims = dims or tuple(range(x.ndim))
    n = 1
    for d in dims:
        n *= like.shape[d]
    return shlocal.sum_over(x, like, dims, keepdim) / n


def _local_as(state_leaf, like, placements):
    """A state leaf's local shard laid out by ``placements``."""
    if like is None:
        return state_leaf
    if list(state_leaf.placements) != list(placements):
        state_leaf = state_leaf.redistribute(like.device_mesh, placements)
    return state_leaf.to_local()


def adafactor(cfg, lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """``cfg``: the model's config, which groups the per-layer leaves as
    the reference stacks them (``reference_groups``)."""
    def _factored(shape) -> bool:
        # both trailing dims large: stacked (L, D) norm vectors stay
        # un-factored instead of factoring across the layer axis
        return (len(shape) >= 2
                and min(shape[-2:]) >= min_dim_size_to_factor)

    def init(params):
        stats = {}
        for name, members, stacked in reference_groups(params, cfg):
            p = tree_get(params, members[0])
            shape = ((len(members),) if stacked else ()) + tuple(p.shape)
            z = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa
                                       device=p.device)
            stats[name] = ({"r": z(*shape[:-1]),
                            "c": z(*shape[:-2], shape[-1])}
                           if _factored(shape) else {"v": z(*shape)})
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_first_leaf(params).device),
                "stats": stats}

    @torch.no_grad()
    def update(grads, state, params):
        step = shlocal.local(state["step"])
        step += 1
        t = torch.clamp(step.float(), min=1.0)
        beta = 1.0 - t ** (-decay)
        updates = tree_map(lambda g: None, grads)
        for name, members, stacked in reference_groups(grads, cfg):
            first = tree_get(grads, members[0])
            g = _gather(grads, members, stacked).float()
            pl = _group_layout(first, stacked)
            shape = ((len(members),) if stacked else ()) + tuple(first.shape)
            # the stacked leaf as a DTensor: only its layout is read
            like = None if pl is None else shlocal.wrap(g, first, pl,
                                                        shape=shape)
            s = state["stats"][name]
            g2 = torch.square(g) + eps
            nd = len(shape)
            if _factored(shape):
                pr = None if like is None else _without(pl, -1, nd)
                pc = None if like is None else _without(pl, -2, nd)
                r = (beta * _local_as(s["r"], like, pr)
                     + (1 - beta) * _mean(g2, like, (-1,)))
                c = (beta * _local_as(s["c"], like, pc)
                     + (1 - beta) * _mean(g2, like, (-2,)))
                r_like = None if like is None else shlocal.wrap(
                    r, first, pr, shape=shape[:-1])
                rc = r / torch.clamp(_mean(r, r_like, (-1,), True),
                                     min=1e-30)
                v = rc[..., None] * c[..., None, :]
                state["stats"][name] = {
                    "r": r if like is None else r_like,
                    "c": c if like is None else shlocal.wrap(
                        c, first, pc, shape=shape[:-2] + shape[-1:])}
            else:
                v = (beta * _local_as(s["v"], like, pl)
                     + (1 - beta) * g2)
                state["stats"][name] = {
                    "v": v if like is None else shlocal.wrap(
                        v, first, pl, shape=shape)}
            u = g / torch.sqrt(torch.clamp(v, min=1e-30))
            rms_u = torch.sqrt(_mean(torch.square(u), like, ()) + 1e-30)
            u = -lr * (u / torch.clamp(rms_u / clip_threshold, min=1.0))
            rows = u.unbind(0) if stacked else (u,)
            for m, row in zip(members, rows):
                tree_set(updates, m,
                         shlocal.wrap(row, tree_get(grads, m)))
        return updates, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, cfg) -> Optimizer:
    """``cfg`` (the model's config) groups Adafactor's leaves as the
    reference stacks them; AdamW is elementwise and ignores it."""
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(cfg, lr=lr)
    raise ValueError(name)


def default_optimizer_name(cfg) -> str:
    """Per-arch default: factored states for >=100B-param models."""
    return "adafactor" if cfg.param_count() > 50e9 else "adamw"

