"""FlashAttention-2-style prefill attention: the hand-written CUDA kernel
and its plain version.

Port of ``repro.kernels.flash_attention.flash_attention`` (the Pallas TPU
kernel ``_fa_kernel``): q ``(B, Sq, H, D)`` against k/v ``(B, Sk, KV, D)``
with GQA and positions aligned; key ``j`` is attended by query ``i`` iff
``j <= i`` when ``causal`` and ``i - j < window`` when a window is given.
Online softmax in float32.

Dispatch: a CUDA tensor launches the kernel in ``csrc/flash_attention.cu``
(bf16 only, ``window`` None or positive, head dim a multiple of 8 up to
256, tensors on 16-byte boundaries) or raises; a CPU tensor takes the
plain version (``ref.attention_ref``).  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from . import _build
from ._build import F, I, P
from .ref import attention_ref

NAME = "flash_attention"
SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:80"

launches = 0

_self = sys.modules[__name__]


def _check(q, k, v, window) -> None:
    B, Sq, H, D = q.shape
    Bk, Sk, KV, Dk = k.shape
    if Bk != B or Dk != D or H % KV or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window {window}: the kernel takes None or a "
                         "positive window")
    _build.check_tensors((("q", q, torch.bfloat16),
                          ("k", k, torch.bfloat16),
                          ("v", v, torch.bfloat16)))
    _build.padded_head_dim(D)
    _build.check_aligned((("q", q), ("k", k), ("v", v)))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KV, D).  Returns (B, Sq, H, D) in q's
    dtype."""
    if not _build.on_card(q):
        return attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    out = torch.empty_like(q)
    _build.launch(_self, "rtlm_flash_attention",
                  [P, P, P, P, I, I, I, I, I, I, I, I, F],
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, H, KV, D, int(causal), window or 0,
                  1.0 / D ** 0.5, device=q.device)
    return out
