"""Real-time serving engine: RT-LM scheduling over the PyTorch model.

Port of ``repro.serving.engine``, restricted to the paper's real-time
serving loop: ``ServingEngine(mode="continuous", kv="paged",
prefill="chunked", decode_steps=N)`` on a dense full-attention stack.  A
request goes through RULEGEN features and the m_theta uncertainty ``u``,
UASCHED priority and admission (a request the policy offloads goes to the
bulk lane), the worst-case block reservation, the token-budgeted chunk
plan packed into one ragged batch, ONE fused prefill launch per iteration
(``model.prefill_chunks`` -> the ``ragged_chunked_prefill`` kernel), and
N-step decode windows over the paged pool (``model.decode_steps_paged``
-> the ``paged_decode_attention`` kernel), with eviction in arrears
through the ``CompletionWorker``.

The bulk lane (``_run_batch``) runs a run-to-completion batch through
``generate`` on the contiguous ring cache, as in the reference.

The host bookkeeping is the reference's, line for line, because the
reference simulator (``repro.core.simulator.simulate_continuous``) mirrors
it and is the port's oracle: completion order, ``budget_trace``, the
prefill and decode dispatch traces, the fused launch's shape-key counters
(``exec_cache_hits``/``misses``), KV utilization samples and
``rejected_for_memory``.  The page pools and per-slot positions live on
the device and are updated in place.

Not ported, and refused with ``NotImplementedError`` naming the ROADMAP
item: ``mode="batch"``, ``kv="contiguous"``, ``prefill="stall"``, the
prefix cache (``prefix_cache``, ``persist_prefix_cache``), fault plans
(``faults``), observability (``obs``) and non-dense model families.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import priority as prio
from ..core import scheduler as sched_lib
from ..kvcache import BlockAllocator, blocks_for_tokens, window_target_tokens
from ..kvcache.paged import PagedKVCache
from ..models import model as model_lib, transformer
from ..obs.metrics import Histogram
from ..prefill import ChunkScheduler, build_packed_arrays, pack_plans
from . import generate
from .pipeline import CompletionWorker

EOS_ID = 1
# max_len headroom past input_bucket + max_new_tokens; it bounds the
# decode window's overhang (decode_steps - 1 dead-row writes past a
# sequence's end), as in the reference
_MAX_LEN_SLACK = 8


def hash_tokenize(text: str, vocab_size: int, max_len: int) -> List[int]:
    """Toy deterministic tokenizer: word -> stable hash id (2..V-1)."""
    toks = []
    for w in text.lower().split()[:max_len]:
        h = 2166136261
        for c in w.encode():
            h = ((h ^ c) * 16777619) & 0xFFFFFFFF
        toks.append(2 + (h % (vocab_size - 2)))
    return toks or [2]


def tokenize_padded(text: str, vocab_size: int, bucket: int) -> np.ndarray:
    """``hash_tokenize`` then LEFT-pad to ``bucket`` (the admission
    bucket the reference engine and simulator hash)."""
    arr = np.zeros((bucket,), np.int32)
    seq = hash_tokenize(text, vocab_size, bucket)
    arr[bucket - len(seq):] = seq
    return arr


@dataclasses.dataclass
class Request:
    text: str
    arrival: float
    task_id: int
    # per-request decode budget (None -> engine default); with EOS
    # disabled this IS the output length
    max_new_tokens: Optional[int] = None
    # filled at completion:
    start: float = -1.0
    finish: float = -1.0
    queue_wait_s: float = -1.0
    lane: str = ""
    out_len: int = 0
    slot: int = -1
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    # per-token emission times (engine clock): token_times[0] is the
    # first-token instant, successive diffs are inter-token latencies
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def response_time(self) -> float:
        return self.finish - self.arrival


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP {item})")


class ServingEngine:
    """Continuous, paged, chunked-prefill engine with a pluggable policy.

    ``params`` must live on ``device``; ``device=None`` means the card and
    raises when none is present.  On the card the model runs the CUDA
    kernels; on the CPU it runs the reference's plain attention path
    (``use_pallas=False``)."""

    def __init__(self, params, cfg, policy: sched_lib.Policy,
                 profile: sched_lib.OfflineProfile, *,
                 input_bucket: int = 32, max_new_tokens: int = 32,
                 xi: float = 2.0, mode: str = "continuous",
                 eos_id: int = EOS_ID, kv: str = "paged",
                 num_slots: Optional[int] = None,
                 kv_block_size: int = 16,
                 kv_num_blocks: Optional[int] = None,
                 prefill: str = "chunked",
                 chunk_size: int = 16,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 decode_steps: int = 1,
                 persist_prefix_cache: bool = False,
                 faults=None, obs=None, device=None):
        self.device = resolve_device(device)
        if mode == "batch":
            raise _not_ported('mode="batch"', "Queue 1 item 6")
        if mode != "continuous":
            raise ValueError(f"unknown mode {mode!r}")
        if kv == "contiguous":
            raise _not_ported('kv="contiguous"', "Queue 1 item 6")
        if kv != "paged":
            raise ValueError(f"unknown kv layout {kv!r}")
        if prefill == "stall":
            raise _not_ported('prefill="stall"', "Queue 1 item 6")
        if prefill != "chunked":
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if prefix_cache or persist_prefix_cache:
            raise _not_ported("the prefix cache", "Queue 1 item 6")
        if faults is not None:
            raise _not_ported("fault plans (faults=)", "Queue 1 item 8")
        if obs is not None:
            raise _not_ported("observability (obs=)", "Queue 1 item 7")
        if cfg.family != "dense":
            raise _not_ported(f"model family {cfg.family!r}",
                              "Queue 1 item 9")
        ok, why = transformer.paged_supported(cfg)
        if not ok:
            raise NotImplementedError(f"paged KV cache: {why}")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got "
                             f"{decode_steps}")
        if decode_steps - 1 > _MAX_LEN_SLACK:
            raise ValueError(
                f"decode_steps={decode_steps}: the eviction lag "
                f"(decode_steps - 1 overhang writes past a sequence's "
                f"end) exceeds the max_len slack ({_MAX_LEN_SLACK})")
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params on {emb.device}, engine device "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.policy = policy
        self.profile = profile
        self.persona = policy.persona
        self.input_bucket = input_bucket
        self.max_new_tokens = max_new_tokens
        self.xi = xi
        self.mode = mode
        self.eos_id = eos_id
        self.kv = kv
        self.max_len = input_bucket + max_new_tokens + _MAX_LEN_SLACK
        self.decode_steps = decode_steps
        self.num_slots = (num_slots if num_slots is not None
                          else self.persona.batch_size)
        self.kv_block_size = kv_block_size
        self.prefill = prefill
        self.chunk_size = chunk_size
        self.token_budget = (token_budget if token_budget is not None
                             else self.num_slots + chunk_size)
        ChunkScheduler(chunk_size, self.token_budget)   # validates
        self.use_kernels = self.device.type == "cuda"
        self.kv_num_blocks = (
            kv_num_blocks if kv_num_blocks is not None
            else self.num_slots * blocks_for_tokens(self.max_len,
                                                    kv_block_size))
        worst = blocks_for_tokens(input_bucket + max_new_tokens - 1,
                                  kv_block_size)
        if worst > self.kv_num_blocks:
            raise ValueError(
                f"kv_num_blocks={self.kv_num_blocks} cannot hold one "
                f"worst-case sequence ({worst} blocks) — admission "
                "would deadlock")
        self.batch_capacity = policy.max_batch()
        self.scheduler_overhead_s = 0.0
        self.paged_cache: Optional[PagedKVCache] = None
        self.allocator: Optional[BlockAllocator] = None
        self.kv_util_samples: List[float] = []
        self._rejected_ids: set = set()
        self.peak_concurrency = 0
        self.prefill_stall_s = 0.0
        self.prefill_stall_max_s = 0.0
        self.budget_trace: List = []
        self.prefill_dispatches = 0
        self.prefill_dispatch_trace: List[int] = []
        self.exec_cache_hits = 0
        self.exec_cache_misses = 0
        self._exec_keys: set = set()
        self.decode_dispatches = 0
        self.decode_steps_total = 0
        self.decode_dispatch_trace: List[int] = []
        self._worker: Optional[CompletionWorker] = None

    # ------------------------------------------------------------------
    def _to_sim_task(self, req: Request) -> prio.SimTask:
        t0 = time.perf_counter()
        u = self.profile.predictor.score(req.text)
        d = prio.priority_point(req.arrival, len(req.text.split()),
                                self.persona.phi, None, xi=self.xi)
        self.scheduler_overhead_s += time.perf_counter() - t0
        return prio.SimTask(task=req, u=float(max(u, 0.0)), r=req.arrival,
                            d=d, input_len=float(len(req.text.split())),
                            true_out_len=0)

    def _tokenize_padded(self, text: str) -> np.ndarray:
        return tokenize_padded(text, self.cfg.vocab_size, self.input_bucket)

    def _cap(self, req: Request) -> int:
        cap = (req.max_new_tokens if req.max_new_tokens is not None
               else self.max_new_tokens)
        return max(1, min(cap, self.max_new_tokens))

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _run_batch(self, batch: Sequence[prio.SimTask], lane: str,
                   now: float) -> float:
        """Execute a run-to-completion bulk-lane batch; returns its finish
        time on the engine clock."""
        Cb = self.batch_capacity
        arr = np.zeros((Cb, self.input_bucket), np.int32)
        for i, t in enumerate(batch):
            arr[i] = self._tokenize_padded(t.task.text)
        # padded rows stop after one token so they never extend the
        # batch's decode horizon
        caps = np.ones((Cb,), np.int32)
        caps[:len(batch)] = [self._cap(t.task) for t in batch]
        t0 = time.perf_counter()
        out_tokens, lengths = generate.generate(
            self.params, self.cfg, self._to_device(arr),
            max_new_tokens=self.max_new_tokens, eos_id=self.eos_id,
            max_lens=caps)
        toks = out_tokens.cpu().numpy()
        lengths = lengths.cpu().numpy()
        dur = time.perf_counter() - t0
        # bulk-lane batches count in the prefill total only: the
        # per-iteration trace is the decode loop's launch profile
        self.prefill_dispatches += 1
        if lane == "cpu":
            dur *= self.persona.cpu_slowdown   # bulk-lane emulation
        finish = now + dur
        horizon = max(max((int(lengths[i]) for i in range(len(batch))),
                          default=1), 1)
        for i, t in enumerate(batch):
            t.start, t.finish, t.lane = now, finish, lane
            t.task.start, t.task.finish, t.task.lane = now, finish, lane
            t.task.queue_wait_s = now - t.r
            t.task.out_len = int(lengths[i])
            t.task.out_tokens = toks[i, :t.task.out_len].tolist()
            t.task.token_times = [now + dur * (j + 1) / horizon
                                  for j in range(t.task.out_len)]
        return finish

    # ------------------------------------------------------------------
    def serve(self, requests: Sequence[Request]) -> Dict:
        """Run a full trace (virtual-time arrivals, real execution)."""
        self.kv_util_samples = []
        self._rejected_ids = set()
        self.peak_concurrency = 0
        self.prefill_stall_s = 0.0
        self.prefill_stall_max_s = 0.0
        self.budget_trace = []
        self.prefill_dispatches = 0
        self.prefill_dispatch_trace = []
        self.exec_cache_hits = 0
        self.exec_cache_misses = 0
        self._exec_keys = set()
        self.decode_dispatches = 0
        self.decode_steps_total = 0
        self.decode_dispatch_trace = []
        self._worker = CompletionWorker()
        try:
            return self._serve_continuous_chunked(requests)
        finally:
            self._worker.close()
            self._worker = None

    def _result(self, done: List[prio.SimTask], n: int) -> Dict:
        rts = (np.array([t.response_time for t in done]) if done
               else np.zeros(1))
        span = (max(t.finish for t in done) - min(t.r for t in done)
                if done else 0.0)
        util = (np.array(self.kv_util_samples)
                if self.kv_util_samples else np.zeros(1))
        ttft_h, itl_h, qw_h = Histogram(), Histogram(), Histogram()
        for t in done:
            times = t.task.token_times
            if times:
                ttft_h.record(times[0] - t.r)
                for d in np.diff(times):
                    itl_h.record(float(d))
            if t.task.queue_wait_s >= 0.0:
                qw_h.record(t.task.queue_wait_s)
        return {
            "mean_response_s": float(rts.mean()),
            "max_response_s": float(rts.max()),
            "throughput_per_min": 60.0 * n / max(span, 1e-9),
            "scheduler_overhead_s": self.scheduler_overhead_s,
            "n_tasks": n,
            "tasks": done,
            "completion_order": [t.task.task_id for t in done],
            "mode": self.mode,
            "kv_util_peak": float(util.max()),
            "kv_util_mean": float(util.mean()),
            "rejected_for_memory": len(self._rejected_ids),
            "peak_concurrency": self.peak_concurrency,
            "ttft_p50": ttft_h.quantile(0.50),
            "ttft_p90": ttft_h.quantile(0.90),
            "ttft_p99": ttft_h.quantile(0.99),
            "itl_p50": itl_h.quantile(0.50),
            "itl_p90": itl_h.quantile(0.90),
            "itl_p99": itl_h.quantile(0.99),
            "queue_wait_p50": qw_h.quantile(0.50),
            "queue_wait_p90": qw_h.quantile(0.90),
            "queue_wait_p99": qw_h.quantile(0.99),
            "prefill_stall_s": self.prefill_stall_s,
            "prefill_stall_max_s": self.prefill_stall_max_s,
            "budget_trace": list(self.budget_trace),
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_dispatch_trace": list(self.prefill_dispatch_trace),
            "exec_cache_hits": self.exec_cache_hits,
            "exec_cache_misses": self.exec_cache_misses,
            "decode_dispatches": self.decode_dispatches,
            "decode_steps_executed": self.decode_steps_total,
            "decode_dispatch_trace": list(self.decode_dispatch_trace),
            "kv": {"kind": self.kv, "num_slots": self.num_slots,
                   "block_size": self.kv_block_size,
                   "num_blocks": self.kv_num_blocks},
            "prefill": {"kind": self.prefill,
                        "chunk_size": self.chunk_size,
                        "token_budget": self.token_budget},
            "pipeline": {"decode_steps": self.decode_steps,
                         "use_kernels": self.use_kernels},
            "device": str(self.device),
        }

    # ------------------------------------------------------------------
    # continuous batching: persistent decode loop with slot recycling
    # ------------------------------------------------------------------

    def _extend_block_tables(self, active, slot_task, slot_gen, slot_cap,
                             alloc, kvc, steps: int) -> None:
        """Before a decode window, extend each active slot's table to cover
        every useful write of the next ``steps`` steps
        (``window_target_tokens``, clamped at the admission reservation);
        overhang writes past the clamp land on the trash page."""
        S = self.input_bucket
        for s in active:
            tid = slot_task[s].task.task_id
            target = alloc.blocks_for(window_target_tokens(
                S, slot_gen[s], slot_cap[s], steps))
            have = len(alloc.table(tid))
            while target > have:
                kvc.extend_table(s, have, alloc.allocate(tid))
                have += 1

    def _advance_decode_window(self, active, window_host, now, dt,
                               slot_task, slot_gen, slot_cap, tokens,
                               done, alloc, kvc, reserved) -> None:
        """Window-end (in-arrears) bookkeeping: consume the (C, n) window
        tokens step-major, record each with its interpolated emission
        time, finish sequences at their EOS/cap step, and evict the
        finished ones, in slot order, only after the whole window is
        consumed (the eviction-lag invariant)."""
        n = window_host.shape[1]
        finished: List[int] = []
        for j in range(n):
            t_j = now - dt + dt * (j + 1) / n
            for s in active:
                if slot_task[s] is None or s in finished:
                    continue
                tok = int(window_host[s, j])
                slot_gen[s] += 1
                task = slot_task[s]
                task.task.out_tokens.append(tok)
                task.task.token_times.append(t_j)
                if tok == self.eos_id or slot_gen[s] >= slot_cap[s]:
                    task.finish = t_j
                    task.task.finish = t_j
                    task.task.out_len = slot_gen[s]
                    done.append(task)
                    finished.append(s)
                else:
                    tokens[s, 0] = tok
        for s in active:
            if s not in finished:
                continue
            tid = slot_task[s].task.task_id
            slot_task[s] = None
            tokens[s, 0] = generate.PAD_ID
            alloc.free_sequence(tid)
            kvc.clear_table(s)
            reserved[s] = 0

    def _paged_setup(self):
        """Build the paged serve state (page pool on the device, host
        allocator); rebuilt per serve."""
        kvc = PagedKVCache(self.cfg, self.num_slots, self.kv_num_blocks,
                           self.kv_block_size, self.max_len,
                           device=self.device)
        alloc = BlockAllocator(self.kv_num_blocks, self.kv_block_size)
        self.paged_cache, self.allocator = kvc, alloc
        return kvc, alloc

    def _serve_continuous_chunked(self, requests: Sequence[Request]) -> Dict:
        """Continuous serve with chunked prefill over the paged pool.

        Admission allocates a slot plus the prompt's blocks and enqueues a
        chunk job; each iteration packs the token budget (decode tokens
        first, then prefill chunks in the policy's priority order), runs
        the whole plan as ONE fused ragged launch, then one N-step decode
        window over all slots."""
        C = self.num_slots
        S = self.input_bucket
        pending = sorted(requests, key=lambda r: r.arrival)
        sim_tasks = [self._to_sim_task(r) for r in pending]
        n = len(sim_tasks)
        queue: List[prio.SimTask] = []
        bulk: List[prio.SimTask] = []
        done: List[prio.SimTask] = []
        kvc, alloc = self._paged_setup()
        cache = kvc.state
        reserved = [0] * C           # per-slot worst-case block holdback
        sched = ChunkScheduler(self.chunk_size, self.token_budget)
        slot_task: List[Optional[prio.SimTask]] = [None] * C  # decoding
        slot_gen = [0] * C
        slot_cap = [0] * C
        job_cap: Dict[int, int] = {}            # slot -> decode cap
        job_tokens: Dict[int, np.ndarray] = {}  # slot -> padded prompt
        job_row: Dict[int, np.ndarray] = {}     # slot -> host table row
        tokens = np.zeros((C, 1), np.int32)
        now = 0.0
        i = 0
        step = 0
        while len(done) < n:
            while i < n and sim_tasks[i].r <= now + 1e-9:
                queue.append(sim_tasks[i])
                i += 1

            # --- admissions: allocate slot + blocks, enqueue chunk job
            free = [s for s in range(C) if slot_task[s] is None
                    and s not in job_cap]
            while queue and free:
                running = ([t for t in slot_task if t is not None]
                           + [j.task for j in sorted(sched.jobs,
                                                     key=lambda j: j.seq)])
                prev_queue = list(queue)
                t0 = time.perf_counter()
                task, lane, rest = self.policy.admit(list(queue), now,
                                                     running)
                self.scheduler_overhead_s += time.perf_counter() - t0
                if task is None:
                    break
                queue = list(rest)
                if lane == "cpu":
                    bulk.append(task)
                    continue
                cap = self._cap(task.task)
                need = blocks_for_tokens(S + cap - 1, self.kv_block_size)
                if need > self.kv_num_blocks - sum(reserved):
                    queue = prev_queue           # leave it queued
                    self._rejected_ids.add(task.task.task_id)
                    break
                slot = free.pop(0)
                reserved[slot] = need
                task.task.queue_wait_s = now - task.r
                # all of the prompt's blocks up front; the slot's DECODE
                # table row stays on the trash page until prefill
                # completes (the decode step writes every row)
                toks = self._tokenize_padded(task.task.text)
                alloc.allocate_n(task.task.task_id, alloc.blocks_for(S))
                row = np.full((kvc.max_blocks_per_seq,), kvc.trash_block,
                              np.int32)
                tbl = alloc.table(task.task.task_id)
                row[:len(tbl)] = tbl
                job_row[slot] = row
                job_tokens[slot] = toks
                job_cap[slot] = cap
                sched.add(task, slot, S, self.policy.assign_priority(task))

            # --- chunk phase: the whole plan as one fused ragged launch
            iter_stall = 0.0
            active0 = [s for s in range(C) if slot_task[s] is not None]
            plans = sched.schedule(len(active0)) if sched.has_jobs else []
            batch_plan = pack_plans(plans)
            if batch_plan is not None:
                key = batch_plan.shape_key
                if key in self._exec_keys:
                    self.exec_cache_hits += 1
                else:
                    self._exec_keys.add(key)
                    self.exec_cache_misses += 1
                entries = [(ch.slot, ch.start,
                            job_tokens[ch.slot][ch.start:
                                                ch.start + ch.length],
                            job_row[ch.slot])
                           for ch in batch_plan.chunks]
                tokens_arr, token_chunk, meta, tabs = build_packed_arrays(
                    key, entries, pad_slot=C,
                    table_width=kvc.max_blocks_per_seq,
                    trash_block=kvc.trash_block)
                stalled = any(t is not None for t in slot_task)
                t0 = time.perf_counter()
                last_logits = model_lib.prefill_chunks(
                    self.params, self.cfg, cache,
                    self._to_device(tokens_arr),
                    self._to_device(token_chunk), self._to_device(meta),
                    self._to_device(tabs),
                    chunk_pad=batch_plan.padded_chunk_len,
                    use_kernels=self.use_kernels)
                # greedy pick on the device: only (Cp,) ids cross to host
                self._worker.submit(torch.argmax(last_logits, dim=-1), t0)
                next_ids, dt = self._worker.collect()
                now += dt
                self.prefill_dispatches += 1     # ONE launch, all chunks
                if stalled:
                    self.prefill_stall_s += dt
                    iter_stall += dt
                for ci, ch in enumerate(batch_plan.chunks):
                    if not ch.finishes:
                        continue
                    s = ch.slot
                    task = ch.job.task
                    first = int(next_ids[ci])
                    cap = job_cap.pop(s)
                    del job_tokens[s], job_row[s]
                    task.start, task.lane = now, "gpu"
                    task.task.start, task.task.lane = now, "gpu"
                    task.task.slot = s
                    task.task.out_tokens = [first]
                    task.task.token_times = [now]
                    if first == self.eos_id or cap <= 1:
                        task.finish = now
                        task.task.finish, task.task.out_len = now, 1
                        done.append(task)
                        alloc.free_sequence(task.task.task_id)
                        reserved[s] = 0
                    else:
                        # the slot joins THIS iteration's decode window
                        kvc.set_table(s, alloc.table(task.task.task_id))
                        slot_task[s] = task
                        slot_gen[s], slot_cap[s] = 1, cap
                        tokens[s, 0] = first
            prefill_toks = sum(p.length for p in plans)
            self.prefill_stall_max_s = max(self.prefill_stall_max_s,
                                           iter_stall)

            active = [s for s in range(C) if slot_task[s] is not None]
            nsteps = self.decode_steps
            if plans or active:
                self.budget_trace.append((len(active0), prefill_toks))
                self.prefill_dispatch_trace.append(1 if plans else 0)
                self.decode_dispatch_trace.append(nsteps if active else 0)
            if active:
                self.peak_concurrency = max(self.peak_concurrency,
                                            len(active))
                # --- one N-step decode WINDOW over ALL slots
                t0 = time.perf_counter()
                self._extend_block_tables(active, slot_task, slot_gen,
                                          slot_cap, alloc, kvc, nsteps)
                window_tok = model_lib.decode_steps_paged(
                    self.params, self.cfg, cache, self._to_device(tokens),
                    kvc.tables_device(), num_steps=nsteps,
                    use_kernels=self.use_kernels)
                self._worker.submit(window_tok, t0)
                window_host, dt = self._worker.collect()
                now += dt
                step += nsteps
                self.decode_dispatches += 1
                self.decode_steps_total += nsteps
                self.kv_util_samples.append(alloc.utilization())
                self._advance_decode_window(
                    active, window_host, now, dt, slot_task, slot_gen,
                    slot_cap, tokens, done, alloc, kvc, reserved)
                continue
            if plans:
                continue

            if bulk and not queue:
                batch, bulk = bulk[:C], bulk[C:]
                now = self._run_batch(batch, "cpu", now)
                done.extend(batch)
                continue

            # idle: advance to the next arrival
            if i < n:
                now = max(now, sim_tasks[i].r)
            else:
                now += self.xi
        return self._result(done, n)
