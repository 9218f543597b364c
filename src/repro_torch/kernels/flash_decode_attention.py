"""Split-K flash-decode attention over a contiguous cache: the hand-written
CUDA kernel and its plain version.

Port of ``repro.kernels.decode_attention.flash_decode_attention`` (the
Pallas TPU kernel ``_fd_kernel``): one-token GQA attention for each of B
rows over a contiguous cache ``(B, S, KV, D)``; slot ``s`` of row ``b`` is
attended iff ``mask[b, s]``.  Online softmax in float32; a row whose mask
is all false returns zeros (the Pallas kernel returns a padding-dependent
average there, the reference oracle a uniform one: ROADMAP Queue 3).

The kernel splits each cache row over S (flash-decoding): ``split_plan``
picks the number of splits on the host, each split writes a float32
partial (m, l, acc) into a workspace allocated here, and a second kernel
in the same C call combines them (``ref.decode_split_partials`` and
``ref.combine_split_partials`` are the plain model of the two passes).

Dispatch: a CUDA tensor launches the kernel in
``csrc/flash_decode_attention.cu`` (bf16 q and caches, bool mask, head dim
a multiple of 8 up to 256, tensors on 16-byte boundaries) or raises; a CPU
tensor takes the plain version (``ref.decode_attention_ref``).
``launches`` counts kernel launches (one per call, both passes).
"""

from __future__ import annotations

import functools
import sys
from typing import Tuple

import torch

from . import _build
from ._build import F, I, P
from .ref import decode_attention_ref

NAME = "flash_decode_attention"
SOURCE = "src/repro_torch/csrc/flash_decode_attention.cu"
REPLACES = "src/repro/kernels/decode_attention.py:66"

#: slots per tile (csrc/split_decode.cuh, kTileKeys): the shortest
#: split, and the unit a split's length is counted in
TILE = 64
#: query heads of a KV group one CTA holds (G is padded up to this)
ROW_BLOCK = 16
#: CTAs the plan aims at per SM
CTAS_PER_SM = 2

launches = 0

_self = sys.modules[__name__]


def split_plan(B: int, H: int, KV: int, S: int,
               sm_count: int) -> Tuple[int, int]:
    """``(n_splits, tiles_per_split)`` for a call of a split-K decode
    kernel (this one, and ``paged_decode_attention`` with ``S = nb * bs``
    logical positions): enough splits of each cache row for about
    ``CTAS_PER_SM`` CTAs per SM over the ``B * KV * ceil(G / 16)``
    groups, never a split shorter than one ``TILE``-slot tile, and no
    empty split (the last may be shorter).  Shapes only: no data is
    read."""
    groups = B * KV * -(-(H // KV) // ROW_BLOCK)
    n_tiles = max(1, -(-S // TILE))
    want = max(1, CTAS_PER_SM * sm_count // max(1, groups))
    per = -(-n_tiles // min(want, n_tiles))
    return -(-n_tiles // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    _build.padded_head_dim(D)
    _build.check_aligned((("q", q), ("k_cache", k_cache),
                          ("v_cache", v_cache)))


def flash_decode_attention(q, k_cache, v_cache, mask) -> torch.Tensor:
    """q (B, H, D); caches (B, S, KV, D); mask (B, S) bool valid slots.
    Returns (B, H, D) in q's dtype."""
    if not _build.on_card(q):
        return decode_attention_ref(q, k_cache, v_cache, mask)
    _check(q, k_cache, v_cache, mask)
    B, H, D = q.shape
    _, S, KV, _ = k_cache.shape
    n_splits, per = split_plan(B, H, KV, S, _sm_count(q.device))
    out = torch.empty_like(q)
    part = torch.empty((B * H * n_splits * (D + 2),), dtype=torch.float32,
                       device=q.device)
    _build.launch(_self, "rtlm_flash_decode_attention",
                  [P, P, P, P, P, P, I, I, I, I, I, I, I, F],
                  q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), part.data_ptr(), B, S, H,
                  KV, D, n_splits, per, 1.0 / D ** 0.5, device=q.device)
    return out
