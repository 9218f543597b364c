"""Hand-written Hopper kernels of the port (counterpart of ``repro.kernels``).

  paged_decode_attention     — flash-decode GQA attention over a block
                               table (replaces the Pallas ``_paged_fd_kernel``)
  ragged_chunked_prefill     — every scheduled prefill chunk of an engine
                               iteration in one launch, chunk K/V scatter
                               fused in (replaces ``_rcp_kernel``)
  chunked_prefill_attention  — one chunk over its paged prefix, the
                               single-chunk prefill path (replaces
                               ``_cp_kernel``)
  rms_norm                   — fused RMSNorm (replaces ``_rms_kernel``)
  flash_attention            — FA2-style prefill attention, GQA, causal and
                               sliding window (replaces ``_fa_kernel``)
  flash_decode_attention     — flash-decode over a contiguous cache with a
                               per-row mask (replaces ``_fd_kernel``)

and two of the paged model path's pointwise chains, fused (no Pallas
counterpart: the reference runs them as plain ``jnp``):

  rope_kv                    — RoPE of q and k with the K/V page write
                               (decode) or the padded-view gather (packed
                               prefill)
  rms_norm.add_rms_norm      — the attention residual add and ``ln2``

Each module holds the wrapper of a CUDA C++ kernel (``csrc/<name>.cu``,
built for ``sm_90a`` by ``_build`` at first use and bound with ``ctypes``)
next to its plain PyTorch version (``ref.py``).  A CUDA tensor launches the
kernel or raises; a CPU tensor takes the plain version.  ``ops`` is the
kernel API of the reference (``repro.kernels.ops``) over these modules.
"""

from . import (chunked_prefill_attention, flash_attention,  # noqa: F401
               flash_decode_attention, ops, paged_decode_attention,
               ragged_chunked_prefill, ref, rms_norm, rope_kv)

#: every kernel module, in the order of PERF.md's kernel table
KERNELS = (paged_decode_attention, ragged_chunked_prefill,
           chunked_prefill_attention, rms_norm, flash_attention,
           flash_decode_attention, rope_kv)
