"""RoPE and the K/V page write of the paged model path: the hand-written
CUDA kernels and their plain versions.

Two entries of ``csrc/rope_kv.cu``, each one launch where the paged
attention layers ran ~37 (decode) or ~35 (packed prefill) plain ones:

  * ``rope_kv_decode``: one decode step's q and k rotated at each row's
    position, the rotated q returned contiguous for the paged decode
    kernel, k and v written into their page pools at that position
    (``ref.rope_kv_decode_ref``: ``layers.apply_rope`` twice,
    ``paged.scatter_token`` twice, ``q[:, 0].contiguous()``);
  * ``rope_kv_packed``: the packed prefill stream's q and k rotated at
    their positions, and the rows the ragged prefill kernel's padded
    per-chunk views take gathered from q, k and v on the way
    (``ref.rope_kv_packed_ref``).

The cos and sin come from ``table`` (L, D) float32, ``layers.rope_table``,
which the paged cache holds on the card (``transformer.init_paged_cache``):
built once with the cache, before any graph is captured, and bound by
identity like the pages.  The kernels round as the plain chains do, so on
the card they give the plain chains' bits.

Dispatch: a CUDA tensor launches the kernel (bf16 tensors only) or
raises; a CPU tensor takes the plain version.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import sys

import torch

from . import _build
from ._build import I, P
from .ref import rope_kv_decode_ref, rope_kv_packed_ref

NAME = "rope_kv"
SOURCE = "src/repro_torch/csrc/rope_kv.cu"
#: no Pallas kernel: the reference's plain ``apply_rope`` (and its
#: ``kvcache/paged.py:59`` ``scatter_token``)
REPLACES = "src/repro/models/layers.py:61"

launches = 0

_self = sys.modules[__name__]
_BF16 = torch.bfloat16


def _check_table(table, D: int) -> None:
    if table is None:
        raise ValueError("the rope_kv kernels need the cos/sin table "
                         "(layers.rope_table; the paged cache's 'rope')")
    if table.ndim != 2 or table.shape[1] != D:
        raise ValueError(f"table {tuple(table.shape)} for head dim {D}")
    if D % 2 or D > 256:
        raise ValueError(f"head dim {D}: the rope_kv kernels take an even "
                         "head dim up to 256")


def rope_kv_decode(q, k, v, pos, block_tables, k_pages, v_pages, *,
                   theta: float, table=None) -> torch.Tensor:
    """q (B, 1, H, D), k/v (B, 1, KV, D); pos (B,) i32; block_tables
    (B, nb) i32; pages (N, bs, KV, D), written in place.  Returns the
    rotated q (B, H, D), contiguous."""
    if not _build.on_card(q):
        return rope_kv_decode_ref(q, k, v, pos, block_tables, k_pages,
                                  v_pages, theta)
    B, _, H, D = q.shape
    N, bs, KV, _ = k_pages.shape
    _check_table(table, D)
    if (tuple(k.shape) != (B, 1, KV, D) or v.shape != k.shape
            or v_pages.shape != k_pages.shape or k_pages.shape[3] != D
            or tuple(pos.shape) != (B,) or block_tables.shape[0] != B):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"pages {tuple(k_pages.shape)}, pos "
                         f"{tuple(pos.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    _build.check_tensors((("q", q, _BF16), ("k", k, _BF16), ("v", v, _BF16),
                          ("pos", pos, torch.int32),
                          ("block_tables", block_tables, torch.int32),
                          ("k_pages", k_pages, _BF16),
                          ("v_pages", v_pages, _BF16),
                          ("table", table, torch.float32)))
    q_out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    _build.launch(_self, "rtlm_rope_kv_decode",
                  [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I],
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                  block_tables.data_ptr(), table.data_ptr(), q_out.data_ptr(),
                  k_pages.data_ptr(), v_pages.data_ptr(), B, H, KV, D, bs,
                  block_tables.shape[1], table.shape[0], device=q.device)
    return q_out


def rope_kv_packed(q, k, v, positions, rows=None, *, theta: float,
                   table=None):
    """q (T, H, D), k (T, KV, D), v (T, KV, D) or None; positions (T,)
    i32; rows (R,) i64 or None (all T rows).  Returns (q, k, v) of R rows:
    row r is packed row ``rows[r]``, q and k rotated at its position (v
    None when v is)."""
    if not _build.on_card(q):
        return rope_kv_packed_ref(q, k, v, positions, rows, theta)
    T, H, D = q.shape
    KV = k.shape[1]
    _check_table(table, D)
    if (tuple(k.shape) != (T, KV, D)
            or (v is not None and v.shape != k.shape)
            or tuple(positions.shape) != (T,)
            or (rows is not None and rows.ndim != 1)):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"positions {tuple(positions.shape)}")
    specs = [("q", q, _BF16), ("k", k, _BF16),
             ("positions", positions, torch.int32),
             ("table", table, torch.float32)]
    if v is not None:
        specs.append(("v", v, _BF16))
    if rows is not None:
        specs.append(("rows", rows, torch.int64))
    _build.check_tensors(specs)
    R = T if rows is None else rows.shape[0]
    dev = q.device
    q_out = torch.empty((R, H, D), dtype=q.dtype, device=dev)
    k_out = torch.empty((R, KV, D), dtype=k.dtype, device=dev)
    v_out = (torch.empty((R, KV, D), dtype=v.dtype, device=dev)
             if v is not None else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    _build.launch(_self, "rtlm_rope_kv_packed",
                  [P, P, P, P, P, P, P, P, P, I, I, I, I, I],
                  q.data_ptr(), k.data_ptr(), ptr(v), positions.data_ptr(),
                  ptr(rows), table.data_ptr(), q_out.data_ptr(),
                  k_out.data_ptr(), ptr(v_out), R, H, KV, D, table.shape[0],
                  device=dev)
    return q_out, k_out, v_out
