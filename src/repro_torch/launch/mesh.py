"""Meshes and device groups (port of ``repro.launch.mesh``).

``make_mesh`` and ``make_production_mesh`` build the ``torch.distributed``
``DeviceMesh`` a ``sharding.policy.ShardingPolicy`` lays tensors out on
(one rank a device; the process group comes first, e.g. from ``torchrun``);
``replica_groups`` maps R serving replicas onto the visible CUDA cards.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the first
    prod(shape) ranks of the initialised process group, one rank a device
    of ``device``'s type (``None`` means the card).  Raises, naming the
    ranks needed, when the world is smaller."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} needs {len(shape)} axis names, "
                         f"got {axes}")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, have {have} — start one "
            f"process a device, e.g. torchrun --nproc-per-node {need}")
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") — 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def replica_groups(R: int, devices: Optional[Sequence] = None
                   ) -> List[list]:
    """Device groups for R serving replicas.

    With at least R devices the replicas get contiguous equal
    data-parallel slices (leftover devices stay unused — equal pools
    keep the replicas interchangeable for the router).  With fewer
    devices than replicas the groups wrap round-robin onto single
    devices: R engine instances time-sharing one device, which is what
    ``serving.replica.ReplicatedEngine`` runs on one card or on the CPU.

    ``devices=None`` means every visible card (``torch.device("cuda",
    i)``) and raises when none is present; a caller on the CPU passes
    ``devices=[torch.device("cpu")]``.
    """
    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices="
                "[torch.device('cpu')] to group replicas on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if not devs:
        raise RuntimeError("no devices available for replica_groups")
    if len(devs) >= R:
        per = len(devs) // R
        return [devs[r * per:(r + 1) * per] for r in range(R)]
    return [[devs[r % len(devs)]] for r in range(R)]
