"""Roofline terms of a dry run on NVIDIA H100 SXM cards (PyTorch port of
``repro.launch.analysis``).

Three terms per (arch x shape x mesh), per card, as in the reference:

    compute_s    = flops            / PEAK_FLOPS
    memory_s     = hbm_bytes        / HBM_BW
    collective_s = collective_bytes / collective_bandwidth(n_devices)

The counts come from ``launch.op_cost`` (per rank, like the reference's
post-SPMD module) and the memory from ``MemTracker`` around the step.

Hardware constants, NVIDIA's H100 SXM5 data sheet (dense rates, no
sparsity, at the card's full 700 W):
  * ``PEAK_FLOPS`` 989 TFLOP/s: bf16 on the tensor cores;
  * ``HBM_BW`` 3.35 TB/s: the 80 GB of HBM3;
  * ``NVLINK_BW`` 450 GB/s a direction: NVLink 4, 900 GB/s both ways,
    between the 8 cards of one node (``NODE_SIZE``);
  * ``NIC_BW`` 50 GB/s: one 400 Gb/s InfiniBand NDR adapter a card, the
    DGX H100 / HGX layout, between nodes.

The collective model is two levels: a mesh that fits in one node moves
its bytes at NVLink's rate, one that spans nodes at the NIC's (a
collective across nodes is held to its slowest link, the NIC, whatever
share of its bytes stays inside a node).  The production meshes of 256
and 512 ranks always span nodes.  Left out, with no analogue here: the
fabric's topology (rails, the switch tiers and their oversubscription),
NVLink SHARP's in-switch reductions, the overlap of collectives with
compute, and per-message latency; the reference's single ICI figure
leaves out the same for its torus.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, one direction, in a node
NIC_BW = 50e9                # bytes/s per card (400 Gb/s), across nodes
NODE_SIZE = 8                # cards per NVLink node
HBM_BYTES = 80e9             # NVIDIA H100 80GB HBM3
CARD = "NVIDIA H100 80GB HBM3"


def collective_bandwidth(n_devices: int) -> float:
    """Bytes/s a card moves in a collective over ``n_devices`` cards."""
    return NVLINK_BW if n_devices <= NODE_SIZE else NIC_BW


@dataclasses.dataclass
class Roofline:
    flops: float                 # per card
    hbm_bytes: float             # per card
    collective_bytes: float      # per card
    model_flops: float           # 6*N(_active)*tokens, per card
    n_devices: int
    raw_flops_once: float = 0.0  # the reference's cost_analysis() count;
    #                              here every op counts each time it runs,
    #                              so it equals ``flops``
    collective_by_kind: Optional[dict] = None
    collective_counts: Optional[dict] = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / collective_bandwidth(self.n_devices)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "model_flops_per_dev": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
            "n_devices": self.n_devices,
            "raw_flops_once": self.raw_flops_once,
            "collective_by_kind": self.collective_by_kind,
            "collective_counts": self.collective_counts,
        }


def model_flops(cfg, shape) -> float:
    """Analytic 6*N*D (dense) / 6*N_active*D (MoE) model FLOPs, global.

    Train counts fwd+bwd (6ND); prefill counts forward only (2ND);
    decode counts one token per sequence (2*N_active*B).
    """
    tokens = shape.global_batch * shape.seq_len
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # one decode step


def analyze(cost, cfg, shape, n_devices: int) -> Roofline:
    """Roofline terms from an ``op_cost.Cost`` of one rank's step."""
    return Roofline(
        flops=cost.flops,
        hbm_bytes=cost.traffic_bytes,
        collective_bytes=cost.collective_bytes,
        model_flops=model_flops(cfg, shape) / n_devices,
        n_devices=n_devices,
        raw_flops_once=cost.flops,
        collective_by_kind=dict(cost.collective_by_kind),
        collective_counts=dict(cost.collective_counts),
    )


def _storages(tree) -> dict:
    """{storage id: bytes} of the local tensors of a tree (a DTensor's
    local shard; views of one storage counted once)."""
    from ..sharding import local as shlocal
    from ..tree import tree_paths
    out = {}
    for _, leaf in tree_paths(tree):
        t = shlocal.local(leaf)
        if not hasattr(t, "untyped_storage"):
            continue
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def memory_summary(tracker, args, outputs) -> dict:
    """The reference's memory keys, per card, from a ``MemTracker`` that
    ran around one step on ``args`` (tracking them as external) and
    returned ``outputs``:

      argument_size_in_bytes — the local bytes of the arguments;
      output_size_in_bytes   — the local bytes of the outputs;
      alias_size_in_bytes    — the output bytes that are argument storage
                               (state the step updates in place, XLA's
                               donated buffers);
      resident_bytes_per_device — the tracker's peak: every live tensor
                               at the step's fullest moment, arguments
                               included;
      temp_size_in_bytes     — what the peak holds beyond the arguments
                               and the new outputs, so that resident =
                               argument + output - alias + temp, the
                               reference's identity.
    """
    a, o = _storages(args), _storages(outputs)
    args_b, out_b = sum(a.values()), sum(o.values())
    alias_b = sum(v for k, v in o.items() if k in a)
    peak = max((snap["Total"] for snap in
                tracker.get_tracker_snapshot("peak").values()), default=0)
    resident = max(int(peak), args_b + out_b - alias_b)
    return {"argument_size_in_bytes": args_b,
            "output_size_in_bytes": out_b,
            "temp_size_in_bytes": resident - (args_b + out_b - alias_b),
            "alias_size_in_bytes": alias_b,
            "resident_bytes_per_device": resident}
