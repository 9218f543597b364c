"""The kernel API (port of ``repro.kernels.ops``).

The six functions of the reference, with its names and argument order.
The reference's ``interpret`` flag and TPU tile sizes (``block_q``,
``block_k``, ``block_rows``) are gone: the CUDA kernels choose their own
tiles.  ``use_kernels`` replaces ``use_pallas``:

  * ``None`` (default): the kernel's wrapper, which launches the CUDA
    kernel for CUDA tensors and takes the plain version for CPU tensors;
  * ``True``: the kernel, and a tensor that is not on a CUDA device raises;
  * ``False``: the plain version (``ref.py``), only when asked for.

There is no silent fallback.  The plain versions are the port's ``ref.py``
functions, not the reference's ``layers`` fallbacks: the reference's
``flash_decode_attention(use_pallas=False)`` builds its positions from
``mask[0]`` and so applies row 0's mask to every row (ROADMAP Queue 3).

``ragged_chunked_prefill`` writes the chunk K/V into the page pools in
place and returns ``(out, k_pages, v_pages)``, the same tensors, where the
reference returns new pools.
"""

from __future__ import annotations

from typing import Optional

from . import (chunked_prefill_attention as _cpa,
               flash_attention as _fa, flash_decode_attention as _fd,
               paged_decode_attention as _pfd,
               ragged_chunked_prefill as _rcp, ref as _ref, rms_norm as _rn)


def _kernel(x, use_kernels: Optional[bool]) -> bool:
    """Whether to call the kernel's wrapper (else the plain version)."""
    if use_kernels and x.device.type != "cuda":
        raise ValueError(f"use_kernels=True needs CUDA tensors, got "
                         f"{x.device}")
    return use_kernels is not False


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    use_kernels: Optional[bool] = None):
    """Prefill attention.  q (B, S, H, D); k/v (B, S, KV, D)."""
    if _kernel(q, use_kernels):
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return _ref.attention_ref(q, k, v, causal=causal, window=window)


def flash_decode_attention(q, k_cache, v_cache, mask, *,
                           use_kernels: Optional[bool] = None):
    """One-token decode attention.  q (B, H, D); caches (B, S, KV, D);
    mask (B, S) bool valid cache slots, one row per sequence."""
    if _kernel(q, use_kernels):
        return _fd.flash_decode_attention(q, k_cache, v_cache, mask)
    return _ref.decode_attention_ref(q, k_cache, v_cache, mask)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           use_kernels: Optional[bool] = None):
    """One-token decode attention over a paged cache.  q (B, H, D); pages
    (N, bs, KV, D); block_tables (B, nb) i32; seq_lens (B,) i32."""
    if _kernel(q, use_kernels):
        return _pfd.paged_flash_decode_attention(q, k_pages, v_pages,
                                                 block_tables, seq_lens)
    return _ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                           block_tables, seq_lens)


def chunked_prefill_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                              *, use_kernels: Optional[bool] = None):
    """Chunked-prefill attention over a paged prefix.  q (B, T, H, D);
    pages (N, bs, KV, D) already holding the chunk's K/V at
    ``ctx_lens .. ctx_lens + T - 1``; block_tables (B, nb) i32; ctx_lens
    (B,) i32."""
    if _kernel(q, use_kernels):
        return _cpa.chunked_prefill_attention(q, k_pages, v_pages,
                                              block_tables, ctx_lens)
    return _ref.chunked_prefill_attention_ref(q, k_pages, v_pages,
                                              block_tables, ctx_lens)


def ragged_chunked_prefill(q, k_new, v_new, k_pages, v_pages, block_tables,
                           meta, *, use_kernels: Optional[bool] = None):
    """Fused ragged chunked prefill: every scheduled chunk in one launch.
    q (C, T_pad, H, D); k_new/v_new (C, T_pad, KV, D) in the page dtype;
    pages (N, bs, KV, D), written in place; block_tables (C, nb) i32;
    meta (C, 4) i32 rows ``[slot, ctx_len, chunk_len, q_offset]``.
    Returns (out, k_pages, v_pages); output rows past ``chunk_len`` are
    padding."""
    fn = (_rcp.ragged_chunked_prefill if _kernel(q, use_kernels)
          else _ref.ragged_chunked_prefill_ref)
    out = fn(q, k_new, v_new, k_pages, v_pages, block_tables, meta)
    return out, k_pages, v_pages


def rms_norm(x, weight, *, eps: float = 1e-6,
             use_kernels: Optional[bool] = None):
    """x (..., D); weight (D,): ``x * rsqrt(mean(x^2) + eps) * (1 + w)``."""
    if _kernel(x, use_kernels):
        return _rn.rms_norm(x, weight, eps)
    return _ref.rms_norm_ref(x, weight, eps)
