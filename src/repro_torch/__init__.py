"""PyTorch/CUDA port of the RT-LM serving system (``repro`` is the JAX reference).

The package mirrors ``repro``'s module paths: ``repro_torch.models.transformer``
is the counterpart of ``repro.models.transformer``, and so on.  It imports
``torch`` and never ``jax`` or ``repro``; the framework-free host modules
(configs, RULEGEN, priorities, the chunk scheduler, the block allocator) are
kept here as copies, pinned to the reference by ``tests/test_torch_*.py``.

What is ported is the real-time serving path: ``ServingEngine(mode=
"continuous", kv="paged", prefill="chunked", decode_steps=N)`` on a dense
full-attention transformer, driven by the RT-LM policy, with its bulk lane.
Its two attention kernels are hand-written CUDA for Hopper
(``csrc/*.cu``); see ``repro_torch.kernels``.

Unlike the functional JAX package, the port updates state in place: page
pools, per-slot positions and ring caches are mutated by the model functions
that own them, and each docstring says so.

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
