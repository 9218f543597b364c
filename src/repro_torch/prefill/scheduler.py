"""Chunked-prefill scheduler: token-budgeted prefill/decode interleaving.

The stall-admission continuous engine (serving/engine.py) blocks the
ENTIRE decode loop for a full ``(1, input_bucket)`` prefill on every
admission — a head-of-line source of inter-token-latency jitter that
grows with the admission burst size (C back-to-back prefills when C
slots free together).  Sarathi-style chunked prefill removes the stall:
each admitted request's (padded) prompt is split into fixed-size
chunks, and every engine iteration packs a TOKEN BUDGET with

    decode tokens first  (one per active decode slot — decode is never
                          skipped; it is the latency-critical work)
  + prefill-chunk tokens (as many whole chunks as fit in the remainder)

so per-iteration prefill work — and therefore the ITL of every in-flight
request — is bounded by ``token_budget`` instead of by the admission
burst.

Chunk ordering is the RT-LM twist: pending jobs are ranked by the
scheduling policy's uncertainty priority (``Policy.assign_priority``,
higher first; admission order breaks ties FIFO), so low-uncertainty
(short-output-predicted) requests reach their first token sooner — the
same signal that orders admission also orders time-to-first-token.

This module is pure host-side Python, deliberately free of JAX: the
real engine (``ServingEngine(prefill="chunked")``) and the simulator
(``simulate_continuous(prefill="chunked")``) drive the SAME scheduler,
which is what makes their per-iteration budget traces and completion
orders comparable bit-for-bit in the parity tests.

``pack_plans`` turns one iteration's plan list into a ``ChunkBatch`` —
the packed, padded layout the FUSED ragged prefill executable consumes
(one launch per iteration instead of one per chunk): adjacent plans of
the same job merge into one contiguous ragged chunk (so every chunk in
a launch belongs to a distinct sequence and the in-kernel K/V scatter
never races), and the batch's ``shape_key`` (padded total tokens,
padded chunk count, padded max chunk length — power-of-two buckets) is
the traced-executable memo key.  Both loops call it: the engine to
build the launch, the simulator to mirror the dispatch count and the
executable-cache hit/miss counters bit for bit.

Invariants (property-tested in tests/test_properties.py):

  * per-iteration budget: scheduled chunk tokens never exceed
    ``max(0, token_budget - decode_tokens)``;
  * in-order chunks: a job's chunks are scheduled at strictly
    increasing offsets covering ``[0, total)`` exactly once;
  * work conservation (no starvation): whenever jobs are pending and
    the budget remainder covers a whole chunk, at least one chunk is
    scheduled — under FIFO tie-break jobs therefore finish prefill in
    admission order and every job's wait is bounded by the backlog
    ahead of it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ChunkJob:
    """One admitted request's prefill work (the padded prompt bucket)."""

    task: object                 # prio.SimTask (engine) or SimTask (sim)
    slot: int                    # decode slot reserved for this request
    total: int                   # prompt tokens to prefill (input bucket)
    priority: float              # Policy.assign_priority at admission
    seq: int                     # admission order (FIFO tie-break)
    done: int = 0                # tokens prefetched so far
    added_at_call: int = 0       # scheduler call index at admission

    @property
    def remaining(self) -> int:
        return self.total - self.done

    def next_chunk_len(self, chunk_size: int) -> int:
        """Whole chunks of ``chunk_size``; the tail chunk is smaller."""
        return min(chunk_size, self.remaining)


@dataclasses.dataclass
class ChunkPlan:
    """One chunk to execute this iteration."""

    job: ChunkJob
    start: int                   # position offset of the chunk
    length: int
    finishes: bool               # True -> this chunk completes the prompt


def _pow2(n: int) -> int:
    """Smallest power of two >= n (bucketing for executable shapes)."""
    p = 1
    while p < n:
        p *= 2
    return p


def pow2_bucket(n: int) -> int:
    """Public alias of the shape-bucketing rule.  The stall-mode
    prefix-suffix launch (a single-chunk ``ChunkBatch`` equivalent)
    must compute the SAME shape key as ``pack_plans`` would — engine
    and simulator both derive ``(pow2(L), 1, pow2(L))`` for a suffix of
    L tokens from this function, keeping their executable-cache
    counters parity-comparable."""
    return _pow2(n)


def suffix_shape_key(suffix_len: int) -> tuple:
    """``ChunkBatch.shape_key`` of a single-chunk launch of
    ``suffix_len`` tokens — what ``pack_plans`` yields for one plan
    covering the whole suffix (the stall-mode prefix-cached admission
    path)."""
    p = _pow2(suffix_len)
    return (p, 1, p)


@dataclasses.dataclass
class PackedChunk:
    """One merged, contiguous ragged chunk of a ``ChunkBatch``.

    Adjacent same-job plans of one iteration merge into one chunk, so
    a batch never holds two chunks of the same sequence (the fused
    kernel's no-write-race invariant) and ``finishes`` is simply the
    last constituent plan's flag (a job's final chunk is always the
    last plan the scheduler emitted for it)."""

    job: ChunkJob
    start: int                   # job-relative offset of the merged run
    length: int
    finishes: bool

    @property
    def slot(self) -> int:
        return self.job.slot


@dataclasses.dataclass
class ChunkBatch:
    """One iteration's plans packed for a single fused launch.

    The padded sizes are power-of-two buckets so the engine's ragged
    prefill executable retraces once per ``shape_key`` instead of once
    per ``(chunk_len, offset)`` pair; the simulator computes the same
    keys from the same plans, which is what makes the executable-cache
    hit/miss counters engine-vs-sim comparable."""

    chunks: List[PackedChunk]
    total_tokens: int            # sum of merged chunk lengths
    padded_tokens: int           # total_tokens -> power-of-two bucket
    padded_chunks: int           # len(chunks) -> power-of-two bucket
    padded_chunk_len: int        # max chunk length -> power-of-two bucket

    @property
    def shape_key(self) -> tuple:
        return (self.padded_tokens, self.padded_chunks,
                self.padded_chunk_len)


def pack_plans(plans: List[ChunkPlan]) -> Optional[ChunkBatch]:
    """Merge one iteration's plans into the fused-launch batch.

    Returns None for an empty plan list.  Plan order is preserved
    (completion order of finishing chunks must match the per-chunk
    execution the parity tests compare against); merging only fuses
    ADJACENT plans of the same job, which the scheduler guarantees are
    contiguous (each job's chunks are emitted back to back within one
    ``schedule`` call)."""
    if not plans:
        return None
    chunks: List[PackedChunk] = []
    for plan in plans:
        if (chunks and chunks[-1].job is plan.job
                and chunks[-1].start + chunks[-1].length == plan.start):
            chunks[-1].length += plan.length
            chunks[-1].finishes = plan.finishes
        else:
            chunks.append(PackedChunk(job=plan.job, start=plan.start,
                                      length=plan.length,
                                      finishes=plan.finishes))
    total = sum(c.length for c in chunks)
    return ChunkBatch(
        chunks=chunks,
        total_tokens=total,
        padded_tokens=_pow2(total),
        padded_chunks=_pow2(len(chunks)),
        padded_chunk_len=_pow2(max(c.length for c in chunks)))


def build_packed_arrays(key: tuple,
                        entries: Sequence[Tuple[int, int, Sequence[int],
                                                Sequence[int]]],
                        *, pad_slot: int, table_width: int,
                        trash_block: int):
    """Build the fused executable's host arrays for one launch.

    The single authoritative encoding of the packed layout (the engine
    and the tests both call it): ``key`` is ``ChunkBatch.shape_key``;
    ``entries`` holds one ``(slot, ctx_len, tokens, table_row)`` tuple
    per merged chunk IN BATCH ORDER — ``tokens`` the chunk's 1-D token
    ids (length == chunk length), ``table_row`` its block table (at
    most ``table_width`` entries, missing tail filled with
    ``trash_block``).

    Returns int32 arrays ``(tokens (1, TTp), token_chunk (TTp,),
    meta (Cp, 4), tables (Cp, table_width))``: chunk ``ci`` owns packed
    columns ``off .. off+len-1`` with meta row
    ``[slot, ctx_len, chunk_len, q_offset]``; padding COLUMNS map to
    the last chunk row past its length (their scatter rows are dropped
    as invalid); padding CHUNK rows carry ``[pad_slot, 0, 0, off]``
    (``pad_slot`` out of range so their ``pos`` update drops) and
    all-trash tables (a scattered page is never revisited — the fused
    kernel's no-write-race contract).
    """
    TTp, Cp, _ = key
    tokens = np.zeros((1, TTp), np.int32)
    token_chunk = np.full((TTp,), Cp - 1, np.int32)
    meta = np.zeros((Cp, 4), np.int32)
    tables = np.full((Cp, table_width), trash_block, np.int32)
    off = 0
    for ci, (slot, ctx_len, toks, table_row) in enumerate(entries):
        ln = len(toks)
        tokens[0, off:off + ln] = toks
        token_chunk[off:off + ln] = ci
        meta[ci] = (slot, ctx_len, ln, off)
        tables[ci, :len(table_row)] = table_row
        off += ln
    for ci in range(len(entries), Cp):
        meta[ci] = (pad_slot, 0, 0, off)
    return tokens, token_chunk, meta, tables


class ChunkScheduler:
    """Token-budgeted chunk packer shared by engine and simulator.

    When a ``repro.obs`` ``MetricsRegistry`` is supplied, each
    ``schedule`` call with pending jobs records the iteration's budget
    utilization ((decode + scheduled chunk tokens) / token_budget) into
    the ``prefill.budget_fill`` histogram, and each job COMPLETING
    prefill records how many ``schedule`` calls it spent in the queue
    into ``prefill.queue_age_iters``.  Both quantities are functions of
    the scheduling decisions alone — the engine and the simulator drive
    the same scheduler, so these histograms compare bit-for-bit in the
    parity tests.
    """

    def __init__(self, chunk_size: int, token_budget: int, metrics=None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if token_budget < chunk_size:
            raise ValueError(
                f"token_budget={token_budget} < chunk_size={chunk_size}: "
                "an idle iteration could never fit one chunk and prefill "
                "would live-lock")
        self.chunk_size = chunk_size
        self.token_budget = token_budget
        self.jobs: List[ChunkJob] = []
        self._seq = 0
        self.metrics = metrics
        self._calls = 0

    # ------------------------------------------------------------------
    @property
    def has_jobs(self) -> bool:
        return bool(self.jobs)

    def slots_in_prefill(self) -> List[int]:
        return [j.slot for j in self.jobs]

    def add(self, task, slot: int, total: int, priority: float) -> ChunkJob:
        if total < 1:
            raise ValueError(f"total must be >= 1, got {total}")
        job = ChunkJob(task=task, slot=slot, total=total,
                       priority=priority, seq=self._seq,
                       added_at_call=self._calls)
        self._seq += 1
        self.jobs.append(job)
        return job

    def schedule(self, decode_tokens: int) -> List[ChunkPlan]:
        """Pack this iteration's budget; advances job progress.

        Decode tokens are charged first (decode always runs); the
        remainder is filled greedily in (priority desc, admission asc)
        order — a job may get several chunks in one iteration, and a
        lower-priority job's smaller tail chunk may ride along when the
        front-runner's next chunk no longer fits.  Completed jobs are
        removed; the caller executes the returned plans in order.
        """
        had_jobs = bool(self.jobs)
        rem = max(0, self.token_budget - decode_tokens)
        plans: List[ChunkPlan] = []
        for job in sorted(self.jobs, key=lambda j: (-j.priority, j.seq)):
            while job.remaining:
                length = job.next_chunk_len(self.chunk_size)
                if length > rem:
                    break
                plans.append(ChunkPlan(
                    job=job, start=job.done, length=length,
                    finishes=(job.remaining == length)))
                job.done += length
                rem -= length
        self.jobs = [j for j in self.jobs if j.remaining]
        if self.metrics is not None:
            if had_jobs:
                chunk_tokens = sum(p.length for p in plans)
                self.metrics.histogram("prefill.budget_fill").record(
                    (decode_tokens + chunk_tokens) / self.token_budget)
            for p in plans:
                if p.finishes:
                    self.metrics.histogram(
                        "prefill.queue_age_iters").record(
                            self._calls - p.job.added_at_call)
        self._calls += 1
        return plans
