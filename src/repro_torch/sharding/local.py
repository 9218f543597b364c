"""Computing on local shards: the counterpart of the code the reference
runs inside ``shard_map`` and of the ops DTensor has no rule for.

A DTensor laid out by a ``ShardingPolicy`` splits each dim it shards
evenly (the policy shards only dims its mesh axes divide), so a rank's
slice of a dim is one contiguous range (``local_range``).  The
collectives here are ``torch.distributed`` calls on the groups of the
mesh's named axes (``mesh.get_group(axis)``):

  * ``all_reduce`` sums (or takes the max of) a local tensor over named
    axes; under autograd a sum's backward passes the gradient through
    unchanged and a mean's divides it by the group size, the adjoints of
    a reduction whose result every rank then uses as one replicated value
    (DTensor's ``Partial -> Replicate`` semantics).  Never reduce a value
    that is already replicated: its gradient would be counted once a rank;
  * ``sum_over`` sums a local tensor over tensor dims, closing the sum
    over the mesh axes that shard those dims;
  * ``owner`` is 1.0 on the one rank of each replica group of a DTensor
    and 0.0 on the others, so a sum over the world counts every element
    once.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist


_DTENSOR = []


def is_dtensor(x) -> bool:
    if not _DTENSOR:        # imported at first use, not with the module
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(x, _DTENSOR[0])


def local(x):
    """A DTensor's local shard (a view of its storage); anything else as
    it is."""
    return x.to_local() if is_dtensor(x) else x


def shard_axes(x, dim: int) -> list:
    """The names of the mesh axes that shard dim ``dim`` of DTensor
    ``x``, outermost first."""
    names = x.device_mesh.mesh_dim_names
    return [names[m] for m, p in enumerate(x.placements)
            if p.is_shard() and p.dim == dim % x.ndim]


def local_range(x, dim: int) -> tuple:
    """(start, length) of this rank's slice of dim ``dim`` of DTensor
    ``x`` (the whole dim for a plain tensor)."""
    n = x.shape[dim]
    if not is_dtensor(x):
        return 0, n
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start = 0
    for m, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim % x.ndim:
            n //= mesh.size(m)
            start += coord[m] * n
    return start, n


def _groups(mesh, axes: Iterable[str]) -> list:
    return [(mesh.get_group(a), mesh.size(mesh.mesh_dim_names.index(a)))
            for a in axes if mesh.size(mesh.mesh_dim_names.index(a)) > 1]


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, mean):
        out = x.clone()
        n = 1
        for g, size in groups:
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g)
            n *= size
        ctx.scale = 1.0 / n if mean else 1.0
        return out / n if mean else out

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale if ctx.scale != 1.0 else grad, None, None


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """``x`` (a local tensor) reduced over the named mesh axes: ``sum``,
    ``mean`` (both differentiable, see the module note) or ``max`` (no
    gradient)."""
    groups = _groups(mesh, axes)
    if not groups:
        return x
    if op == "max":
        out = x.clone()
        for g, _ in groups:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
        return out
    return _AllReduce.apply(x, groups, op == "mean")


def sum_over(x_local: torch.Tensor, like, dims: Sequence[int],
             keepdim: bool = False) -> torch.Tensor:
    """The sum of ``x_local`` over tensor ``dims``, where ``x_local`` is
    laid out as DTensor ``like`` (or is a plain tensor): the local sum,
    closed over the mesh axes that shard any of ``dims``."""
    out = x_local.sum(dim=tuple(dims), keepdim=keepdim)
    if not is_dtensor(like):
        return out
    axes = [a for d in dims for a in shard_axes(like, d)]
    return all_reduce(out, like.device_mesh, axes)


def owner(x) -> float:
    """1.0 where this rank holds the first copy of its shard of DTensor
    ``x`` (coordinate 0 on every mesh dim that replicates ``x``), else
    0.0; 1.0 for a plain tensor."""
    if not is_dtensor(x):
        return 1.0
    coord = x.device_mesh.get_coordinate()
    return float(all(coord[m] == 0 for m, p in enumerate(x.placements)
                     if not p.is_shard()))


def world_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank of the default group (no gradient)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        x = x.clone()
        dist.all_reduce(x)
    return x


def wrap(x_local: torch.Tensor, like, placements: Optional[list] = None,
         shape=None):
    """``x_local`` as a DTensor on ``like``'s mesh with ``placements``
    (``like``'s by default); ``x_local`` itself when ``like`` is plain."""
    if not is_dtensor(like):
        return x_local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x_local, like.device_mesh,
                              placements or like.placements,
                              run_check=False, shape=shape,
                              stride=None if shape is None else
                              torch.empty(shape, device="meta").stride())


def layout_like(src, dst, whole_dim: Optional[int] = None):
    """``src`` as a DTensor laid out as DTensor ``dst``, but with dim
    ``whole_dim`` (if given) whole on every rank; a plain ``src`` is
    taken as replicated first."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dst.device_mesh
    want = [Replicate() if p.is_shard() and p.dim == whole_dim else p
            for p in dst.placements]
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * len(want),
                                 run_check=False)
    if list(src.placements) == want:
        return src
    return src.redistribute(mesh, want)


def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place; for a DTensor ``dst`` the copy runs on
    the local shards after ``src`` is laid out as ``dst``."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.to_local().copy_(layout_like(src, dst).to_local())


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def scale_grad(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x`` unchanged, its gradient scaled by ``scale``: a value every
    rank of an axis computes alike, inside a pass whose gradients are
    summed over that axis as partials, passes ``1 / size`` of its gradient
    on each rank so that the sum counts it once."""
    return x if scale == 1.0 else _ScaleGrad.apply(x, scale)
