"""Paged KV-cache subsystem (port of ``repro.kvcache``).

  allocator.BlockAllocator / blocks_for_tokens / window_target_tokens —
      a copy of the reference's host-side allocator and its formulas (the
      engine and the reference simulator must compute reservations
      identically for the parity tests).
  paged.PagedKVCache — per-layer K/V page pools as torch tensors plus the
      gather/scatter primitives, updated in place.

The prefix cache (``repro.kvcache.prefix``) is not ported yet.
"""

from .allocator import (BlockAllocator, blocks_for_tokens,  # noqa: F401
                        window_target_tokens)
from .paged import PagedKVCache  # noqa: F401
