"""Hand-written Hopper kernels of the serving path (port of ``repro.kernels``).

  paged_decode_attention  — flash-decode GQA attention over a block table
                            (replaces the Pallas ``_paged_fd_kernel``)
  ragged_chunked_prefill  — every scheduled prefill chunk of an engine
                            iteration in one launch, chunk K/V scatter fused
                            in (replaces the Pallas ``_rcp_kernel``)

Each module holds the wrapper of a CUDA C++ kernel (``csrc/<name>.cu``,
built for ``sm_90a`` by ``_build`` at first use and bound with ``ctypes``)
next to its plain PyTorch version (``ref.py``).  A CUDA tensor launches the
kernel or raises; a CPU tensor takes the plain version.  The other Pallas
kernels of the reference (chunked prefill attention, RMSNorm, flash
attention, contiguous flash decode) are not ported yet (ROADMAP Queue 2).
"""

from . import paged_decode_attention, ragged_chunked_prefill, ref  # noqa: F401

#: the kernel modules of the serving path, in the order chip_smoke reports them
KERNELS = (paged_decode_attention, ragged_chunked_prefill)
