"""Flash-decode attention over a contiguous cache: the hand-written CUDA
kernel and its plain version.

Port of ``repro.kernels.decode_attention.flash_decode_attention`` (the
Pallas TPU kernel ``_fd_kernel``): one-token GQA attention for each of B
rows over a contiguous cache ``(B, S, KV, D)``; slot ``s`` of row ``b`` is
attended iff ``mask[b, s]``.  Online softmax in float32; a row whose mask
is all false returns zeros (the Pallas kernel returns a padding-dependent
average there, the reference oracle a uniform one: ROADMAP Queue 3).

Dispatch: a CUDA tensor launches the kernel in
``csrc/flash_decode_attention.cu`` (bf16 q and caches, bool mask) or
raises; a CPU tensor takes the plain version (``ref.decode_attention_ref``).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from ._build import F, I, P
from .ref import decode_attention_ref

NAME = "flash_decode_attention"
SOURCE = "src/repro_torch/csrc/flash_decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:66"

launches = 0

_self = sys.modules[__name__]


def _check(q, k_cache, v_cache, mask) -> None:
    B, H, D = q.shape
    Bk, S, KV, Dk = k_cache.shape
    if Bk != B or Dk != D or H % KV or v_cache.shape != k_cache.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if tuple(mask.shape) != (B, S):
        raise ValueError(f"mask {tuple(mask.shape)}, expected {(B, S)}")
    _build.check_tensors((("q", q, torch.bfloat16),
                          ("k_cache", k_cache, torch.bfloat16),
                          ("v_cache", v_cache, torch.bfloat16),
                          ("mask", mask, torch.bool)))


def flash_decode_attention(q, k_cache, v_cache, mask) -> torch.Tensor:
    """q (B, H, D); caches (B, S, KV, D); mask (B, S) bool valid slots.
    Returns (B, H, D) in q's dtype."""
    if not _build.on_card(q):
        return decode_attention_ref(q, k_cache, v_cache, mask)
    _check(q, k_cache, v_cache, mask)
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    out = torch.empty_like(q)
    _build.launch(_self, "rtlm_flash_decode_attention",
                  [P, P, P, P, P, I, I, I, I, I, F],
                  q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), B, S, H, KV, D,
                  1.0 / D ** 0.5, device=q.device)
    return out
