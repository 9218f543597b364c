"""Chunked-prefill attention over a paged prefix: the hand-written CUDA
kernel and its plain version.

Port of ``repro.kernels.chunked_prefill_attention.chunked_prefill_attention``
(the Pallas TPU kernel ``_cp_kernel``): one T-token chunk per sequence over
a page pool ``(N, bs, KV, D)`` named by a ``(B, nb)`` block table.  The
pages already hold the chunk's own K/V at logical positions
``ctx_lens[b] .. ctx_lens[b] + T - 1`` (the caller scatters first, as
``transformer._attn_chunk_paged`` does); query ``t`` attends positions
``<= ctx_lens[b] + t``.  Online softmax in float32; nothing is written.

The kernel is the fused ragged prefill's tensor-core body
(``csrc/prefill_attn.cuh``) over pages only (``ref.chunked_prefill_tiles``
is the plain model of its arithmetic).

Dispatch: a CUDA tensor launches the kernel in
``csrc/chunked_prefill_attention.cu`` (bf16 only, head dim a multiple of 8
up to 256, tensors on 16-byte boundaries) or raises; a CPU tensor takes
the plain version (``ref.chunked_prefill_attention_ref``).  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from ._build import F, I, P
from .ref import chunked_prefill_attention_ref

NAME = "chunked_prefill_attention"
SOURCE = "src/repro_torch/csrc/chunked_prefill_attention.cu"
REPLACES = "src/repro/kernels/chunked_prefill_attention.py:88"

launches = 0

_self = sys.modules[__name__]


def _check(q, k_pages, v_pages, block_tables, ctx_lens) -> None:
    B, T, H, D = q.shape
    N, bs, KV, Dk = k_pages.shape
    if Dk != D or H % KV or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if block_tables.shape[0] != B or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"tables {tuple(block_tables.shape)}, ctx_lens "
                         f"{tuple(ctx_lens.shape)} for batch {B}")
    _build.check_tensors((("q", q, torch.bfloat16),
                          ("k_pages", k_pages, torch.bfloat16),
                          ("v_pages", v_pages, torch.bfloat16),
                          ("block_tables", block_tables, torch.int32),
                          ("ctx_lens", ctx_lens, torch.int32)))
    _build.padded_head_dim(D)
    _build.check_aligned((("q", q), ("k_pages", k_pages),
                          ("v_pages", v_pages)))


def chunked_prefill_attention(q, k_pages, v_pages, block_tables,
                              ctx_lens) -> torch.Tensor:
    """q (B, T, H, D); pages (N, bs, KV, D); block_tables (B, nb) i32;
    ctx_lens (B,) i32 prior-context lengths.  Returns (B, T, H, D) in q's
    dtype."""
    if not _build.on_card(q):
        return chunked_prefill_attention_ref(q, k_pages, v_pages,
                                             block_tables, ctx_lens)
    _check(q, k_pages, v_pages, block_tables, ctx_lens)
    B, T, H, D = q.shape
    _, bs, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    _build.launch(_self, "rtlm_chunked_prefill_attention",
                  [P, P, P, P, P, P, I, I, I, I, I, I, I, F],
                  q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_tables.data_ptr(), ctx_lens.data_ptr(),
                  out.data_ptr(), B, T, H, KV, D, bs, block_tables.shape[1],
                  1.0 / D ** 0.5, device=q.device)
    return out
