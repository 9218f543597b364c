"""Paged flash-decode attention: the hand-written CUDA kernel and its plain
version.

Port of ``repro.kernels.paged_decode_attention.paged_flash_decode_attention``
(the Pallas TPU kernel ``_paged_fd_kernel``).  One-token GQA attention for
each of B sequences over a page pool ``(N, bs, KV, D)`` named by a
``(B, nb)`` block table: key position ``p`` of row ``b`` is row ``p % bs``
of page ``tables[b, p // bs]`` and is attended iff ``p < seq_lens[b]``.
Online softmax in float32; a ``seq_len == 0`` row returns zeros.

Dispatch: a CUDA tensor launches the kernel in ``csrc/paged_decode_attention.cu``
(bf16 only) or raises; a CPU tensor takes the plain version
(``ref.paged_decode_attention_ref``).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import paged_decode_attention_ref

NAME = "paged_decode_attention"
SOURCE = "src/repro_torch/csrc/paged_decode_attention.cu"
REPLACES = "src/repro/kernels/paged_decode_attention.py:84"

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load(NAME).rtlm_paged_decode_attention
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_pages, v_pages, block_tables, seq_lens) -> None:
    B, H, D = q.shape
    N, bs, KV, Dk = k_pages.shape
    if Dk != D or H % KV or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if block_tables.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"tables {tuple(block_tables.shape)}, seq_lens "
                         f"{tuple(seq_lens.shape)} for batch {B}")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_pages", k_pages, torch.bfloat16),
                        ("v_pages", v_pages, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("seq_lens", seq_lens, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {t.dtype}, the kernel takes {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def paged_flash_decode_attention(q, k_pages, v_pages, block_tables,
                                 seq_lens) -> torch.Tensor:
    """q (B, H, D); pages (N, bs, KV, D); block_tables (B, nb) i32 page
    ids; seq_lens (B,) i32 valid lengths.  Returns (B, H, D) in q's
    dtype."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k_pages, v_pages, block_tables, seq_lens)
    B, H, D = q.shape
    _, bs, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
               block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
               B, H, KV, D, bs, block_tables.shape[1], 1.0 / D ** 0.5,
               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_build.load(NAME), rc, NAME)
    launches += 1
    return out
