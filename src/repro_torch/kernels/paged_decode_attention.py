"""Paged flash-decode attention: the hand-written CUDA kernel and its plain
version.

Port of ``repro.kernels.paged_decode_attention.paged_flash_decode_attention``
(the Pallas TPU kernel ``_paged_fd_kernel``).  One-token GQA attention for
each of B sequences over a page pool ``(N, bs, KV, D)`` named by a
``(B, nb)`` block table: key position ``p`` of row ``b`` is row ``p % bs``
of page ``tables[b, p // bs]`` and is attended iff ``p < seq_lens[b]``.
Online softmax in float32; a ``seq_len == 0`` row returns zeros.

The kernel is the split-K design of ``flash_decode_attention`` over the
block table: ``flash_decode_attention.split_plan`` cuts each sequence's
``nb * bs`` logical positions into splits, from shapes alone (the wrapper
never reads ``seq_lens`` on the host, so the decode loop never waits on
the card here); each split writes a float32 partial into a workspace
allocated here, and a second kernel in the same C call combines them
(``ref.paged_decode_split_partials`` and ``ref.combine_split_partials`` are
the plain model of the two passes).

Dispatch: a CUDA tensor launches the kernel in
``csrc/paged_decode_attention.cu`` (bf16 q and pages, i32 tables and
lengths, head dim a multiple of 8 up to 256, tensors on 16-byte
boundaries) or raises; a CPU tensor takes the plain version
(``ref.paged_decode_attention_ref``).  ``launches`` counts kernel launches
(one per call, both passes).
"""

from __future__ import annotations

import sys

import torch

from . import _build
from . import flash_decode_attention as _fd
from ._build import F, I, P
from .ref import paged_decode_attention_ref

NAME = "paged_decode_attention"
SOURCE = "src/repro_torch/csrc/paged_decode_attention.cu"
REPLACES = "src/repro/kernels/paged_decode_attention.py:84"

launches = 0

_self = sys.modules[__name__]


def _check(q, k_pages, v_pages, block_tables, seq_lens) -> None:
    B, H, D = q.shape
    N, bs, KV, Dk = k_pages.shape
    if Dk != D or H % KV or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if block_tables.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"tables {tuple(block_tables.shape)}, seq_lens "
                         f"{tuple(seq_lens.shape)} for batch {B}")
    _build.check_tensors((("q", q, torch.bfloat16),
                          ("k_pages", k_pages, torch.bfloat16),
                          ("v_pages", v_pages, torch.bfloat16),
                          ("block_tables", block_tables, torch.int32),
                          ("seq_lens", seq_lens, torch.int32)))
    _build.padded_head_dim(D)
    _build.check_aligned((("q", q), ("k_pages", k_pages),
                          ("v_pages", v_pages)))


def paged_flash_decode_attention(q, k_pages, v_pages, block_tables,
                                 seq_lens) -> torch.Tensor:
    """q (B, H, D); pages (N, bs, KV, D); block_tables (B, nb) i32 page
    ids; seq_lens (B,) i32 valid lengths.  Returns (B, H, D) in q's
    dtype."""
    if not _build.on_card(q):
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens)
    _check(q, k_pages, v_pages, block_tables, seq_lens)
    B, H, D = q.shape
    _, bs, KV, _ = k_pages.shape
    nb = block_tables.shape[1]
    n_splits, per = _fd.split_plan(B, H, KV, nb * bs,
                                   _fd._sm_count(q.device))
    out = torch.empty_like(q)
    part = torch.empty((B * H * n_splits * (D + 2),), dtype=torch.float32,
                       device=q.device)
    _build.launch(_self, "rtlm_paged_decode_attention",
                  [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F],
                  q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), seq_lens.data_ptr(),
                  out.data_ptr(), part.data_ptr(), B, H, KV, D, bs, nb,
                  n_splits, per, 1.0 / D ** 0.5, device=q.device)
    return out
