"""PyTorch/CUDA port of the RT-LM serving system (``repro`` is the JAX reference).

The package mirrors ``repro``'s module paths: ``repro_torch.models.transformer``
is the counterpart of ``repro.models.transformer``, and so on.  It imports
``torch`` and never ``jax`` or ``repro``; the framework-free host modules
(configs, RULEGEN, priorities, the chunk scheduler, the block allocator) are
kept here as copies, pinned to the reference by ``tests/test_torch_*.py``.

What is ported:

  * the serving engine on every family the reference's engine serves: the
    dense and MoE stacks, with full or sliding-window attention, and the
    recurrent stacks (Mamba-2; RG-LRU with local attention), on every
    valid row of the reference's configuration matrix for the family
    (batch mode; continuous stall admission on the contiguous or paged
    cache; continuous chunked prefill on the paged cache; the prefix
    cache; windows and recurrent state on the contiguous rows only),
    driven by any policy, with the bulk lane, and its observability
    (``repro_torch.obs``: lifecycle traces, metrics, SLO monitor,
    calibration ledger);
  * multi-replica serving with fault injection (``serving.router``,
    ``serving.faults``, ``serving.replica.ReplicatedEngine``; R engines on
    one card share the parameters, each with its own page pool and CUDA
    graphs);
  * the vlm and encoder-decoder families at model level (``model.prefill``
    / ``decode_step``, ``generate.generate`` with ``patches=`` /
    ``frames=``), as the reference serves them: its engine builds batches
    of tokens only, and the port's refuses them;
  * training (``repro_torch.training``: ``model.lm_loss``, AdamW and
    Adafactor, the train step, the synthetic data, checkpoints in the
    reference's format) and the launchers ``launch.train`` and
    ``launch.serve``;
  * the sharding layer (``repro_torch.sharding``: the reference's
    logical-axis policy on a ``torch.distributed`` ``DeviceMesh``, DTensor
    parameters, caches and optimizer state, the expert-parallel MoE path)
    under ``launch.train --mesh`` and model-level ``prefill`` /
    ``decode_step``; as in the reference, the serving engine runs
    unsharded;
  * the dry-run tools (``launch.dryrun`` / ``dryrun_all`` over
    ``launch.specs``, ``launch.op_cost`` and ``launch.analysis``): a
    published config's step on fake tensors on a fake world of 256 or 512
    ranks, its per-card flops, bytes and resident memory, and the H100
    roofline;
  * the discrete-event simulator (``core.simulator``), a copy of the
    reference's.

The paged rows' two attention kernels are hand-written CUDA for Hopper
(``csrc/*.cu``), like the four other kernels of the reference; see
``repro_torch.kernels``.

Unlike the functional JAX package, the port updates state in place: page
pools, per-slot positions, ring caches and, in training, the parameters
and the optimizer state are mutated by the functions that own them, and
each docstring says so.

Every entry point takes a ``device`` and runs on ``cuda`` unless the caller
passes ``device="cpu"``; ``resolve_device`` raises when no card is present.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Raises rather than falling back to the CPU
    when ``cuda`` is asked for and no device is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
