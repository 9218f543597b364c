"""Chunked-prefill scheduling (token-budgeted prefill/decode interleave).

Entry points:

  * ``ChunkScheduler`` — the host-side packer: per-iteration token
    budget filled with decode tokens first, then whole prefill chunks
    in the policy's uncertainty-priority order (FIFO tie-break).  Pure
    Python, JAX-free, and shared VERBATIM by the real serving engine
    (``ServingEngine(prefill="chunked")``) and the simulator
    (``simulate_continuous(prefill="chunked")``) — which is what makes
    their per-iteration budget traces comparable bit for bit.
  * ``ChunkJob`` / ``ChunkPlan`` — one admitted prompt's remaining
    work, and one scheduled chunk (start offset, length, finishes).
    With the prefix cache on, a job covers only the UNCACHED suffix of
    the prompt; the engine shifts plan offsets by the cached-prefix
    length.
  * ``pack_plans`` / ``ChunkBatch`` / ``PackedChunk`` — one
    iteration's plans merged (adjacent same-job plans fuse into one
    contiguous ragged chunk) and padded to power-of-two shape buckets
    for the FUSED ragged prefill executable: one launch per iteration,
    ``shape_key`` as the traced-executable memo key.  Shared by engine
    and simulator so dispatch counts and executable-cache hit/miss
    counters parity-match.

Invariants (property-tested in tests/test_properties.py): scheduled
chunk tokens never exceed ``max(0, token_budget - decode_tokens)``;
each job's chunks cover ``[0, total)`` in order exactly once; whenever
jobs pend and a whole chunk fits, at least one chunk is scheduled (no
starvation — FIFO ties drain in admission order).

This package is a copy of ``repro.prefill`` (pure host-side Python): the
port's engine and the reference simulator drive the same packer, which is
what the port's engine-vs-simulator parity tests rely on.

Kernel dispatch in the port: the chunked engine executes ALL of an
iteration's scheduled chunks in ONE launch — ``pack_plans`` builds the
packed batch, ``repro_torch.models.model.prefill_chunks`` runs it through
the stack, and each attention layer calls the hand-written CUDA
``ragged_chunked_prefill`` kernel (K/V scatter fused in) on the card, or
the plain path (drop-mode packed scatter + per-chunk
``layers.chunked_attention`` over the gathered view) when asked.
"""

from .scheduler import (ChunkBatch, ChunkJob, ChunkPlan, ChunkScheduler,
                        PackedChunk, build_packed_arrays, pack_plans,
                        pow2_bucket, suffix_shape_key)

__all__ = ["ChunkBatch", "ChunkJob", "ChunkPlan", "ChunkScheduler",
           "PackedChunk", "build_packed_arrays", "pack_plans",
           "pow2_bucket", "suffix_shape_key"]
