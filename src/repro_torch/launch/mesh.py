"""Device groups for serving replicas (port of ``repro.launch.mesh``).

Only ``replica_groups`` is ported: it maps R serving replicas onto the
visible CUDA cards.  The reference's ``make_production_mesh`` and
``make_mesh`` build ``jax.make_mesh`` meshes for sharded training and
serving; their counterpart is a ``torch.distributed`` ``DeviceMesh``,
which comes with training, sharding and launch (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


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
