"""Fused ragged chunked prefill: the hand-written CUDA kernel and its plain
version.

Port of ``repro.kernels.ragged_chunked_prefill.ragged_chunked_prefill``
(the Pallas TPU kernel ``_rcp_kernel``): every scheduled chunk of one
engine iteration in one launch.  Chunk ``c`` (meta row
``[slot, ctx_len, chunk_len, q_offset]``) writes its fresh K/V rows
``t < chunk_len`` into its pages at logical positions ``ctx_len + t``, IN
PLACE (the reference returns aliased new pools), and each query row ``t``
attends over the prefix positions ``< ctx_len`` plus the chunk's own rows
``t_kv <= t``, ``t_kv < chunk_len``.  A ``chunk_len == 0`` padding chunk
writes nothing.  Rows ``t >= chunk_len`` of the output are padding.

Dispatch: a CUDA tensor launches the kernel in ``csrc/ragged_chunked_prefill.cu``
(bf16 only) or raises; a CPU tensor takes the plain version
(``ref.ragged_chunked_prefill_ref``).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ragged_chunked_prefill_ref

NAME = "ragged_chunked_prefill"
SOURCE = "src/repro_torch/csrc/ragged_chunked_prefill.cu"
REPLACES = "src/repro/kernels/ragged_chunked_prefill.py:154"

META_SLOT, META_CTX, META_LEN, META_QOFF = 0, 1, 2, 3

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _fn():
    fn = _build.load(NAME).rtlm_ragged_chunked_prefill
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_new, v_new, k_pages, v_pages, block_tables, meta) -> None:
    C, T, H, D = q.shape
    N, bs, KV, Dk = k_pages.shape
    if (Dk != D or H % KV or v_pages.shape != k_pages.shape
            or tuple(k_new.shape) != (C, T, KV, D)
            or v_new.shape != k_new.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, pages "
                         f"{tuple(k_pages.shape)}")
    if block_tables.shape[0] != C or tuple(meta.shape) != (C, 4):
        raise ValueError(f"tables {tuple(block_tables.shape)}, meta "
                         f"{tuple(meta.shape)} for {C} chunks")
    for name, t, dt in (("q", q, torch.bfloat16),
                        ("k_new", k_new, torch.bfloat16),
                        ("v_new", v_new, torch.bfloat16),
                        ("k_pages", k_pages, torch.bfloat16),
                        ("v_pages", v_pages, torch.bfloat16),
                        ("block_tables", block_tables, torch.int32),
                        ("meta", meta, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {t.dtype}, the kernel takes {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def ragged_chunked_prefill(q, k_new, v_new, k_pages, v_pages, block_tables,
                           meta) -> torch.Tensor:
    """q (C, T_pad, H, D); k_new/v_new (C, T_pad, KV, D) in the page dtype;
    pages (N, bs, KV, D), written in place; block_tables (C, nb) i32;
    meta (C, 4) i32.  Returns out (C, T_pad, H, D) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return ragged_chunked_prefill_ref(q, k_new, v_new, k_pages, v_pages,
                                          block_tables, meta)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k_new, v_new, k_pages, v_pages, block_tables, meta)
    C, T, H, D = q.shape
    _, bs, KV, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _fn()(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
               k_pages.data_ptr(), v_pages.data_ptr(),
               block_tables.data_ptr(), meta.data_ptr(), out.data_ptr(),
               C, T, H, KV, D, bs, block_tables.shape[1], 1.0 / D ** 0.5,
               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(_build.load(NAME), rc, NAME)
    launches += 1
    return out
