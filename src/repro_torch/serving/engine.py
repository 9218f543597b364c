"""Real-time serving engine: RT-LM scheduling over the PyTorch model.

Port of ``repro.serving.engine`` on the dense and MoE stacks, full
attention on every row, and on the sliding-window and recurrent (Mamba-2,
RG-LRU with local attention) stacks on the contiguous rows (the paged
cache refuses a window and recurrent state, as the reference's
``transformer.paged_supported`` does); the vlm and encdec families are
refused (``refuse_frontends``).  A
request goes through RULEGEN features and the m_theta uncertainty ``u``,
then UASCHED priority and admission (a request the policy offloads goes
to the bulk lane), and runs in one of the reference's two modes:

  * ``mode="batch"`` (the paper's run-to-completion baseline):
    ``policy.select`` forms whole batches, each decoded through
    ``generate`` on the contiguous ring cache until its longest member
    finishes (``_run_batch``, which also serves the bulk lane);
  * ``mode="continuous"``: a persistent decode loop over C slots in which
    ``policy.admit`` fills each freed slot, with N-step decode windows and
    eviction in arrears through the ``CompletionWorker``.  The KV layout
    is ``kv="contiguous"`` (a private ring per slot) or ``kv="paged"``
    (one block pool, a worst-case block reservation per admission), and
    the prompt enters by ``prefill="stall"`` (one full prefill per
    admission, ``model.prefill_into_slot`` / ``prefill_into_paged``) or,
    on the paged pool, ``prefill="chunked"`` (the token-budgeted chunk
    plan packed into ONE fused launch per iteration,
    ``model.prefill_chunks`` -> the ``ragged_chunked_prefill`` kernel).
    Paged decode windows run ``model.decode_steps_paged`` -> the
    ``paged_decode_attention`` kernel.  ``prefix_cache=True`` (paged)
    shares cached prompt blocks through ``kvcache.PrefixCache``: a hit
    copies-on-write a fully matched last block
    (``transformer.copy_paged_block``) and prefills only the uncached
    suffix through the fused ragged launch; ``persist_prefix_cache=True``
    keeps the pool and index across serves.

The host bookkeeping is the reference's, line for line, because the
reference simulator (``repro.core.simulator.simulate`` and
``simulate_continuous``) mirrors it and is the port's oracle: completion
order, ``budget_trace``, the prefill and decode dispatch traces, the
fused launch's shape-key counters (``exec_cache_hits``/``misses``), KV
utilization samples, ``rejected_for_memory`` and the prefix-cache
counters.  Caches live on the device and are updated in place.

Every device step of the continuous loops (the decode window, the stall
admission, the copy-on-write page copy and the fused ragged prefill)
dispatches through a ``generate.GraphExecutable``, the counterpart of the
reference's ``JitExecutable``: on the card each shape key replays a CUDA
graph, captured at serve start (``aot_warmup=True``, the reference's
``_aot_warm``) or on its first call.  Under ``generate.disable_graphs()``
and on the CPU every step runs eagerly.  Batch mode and the bulk lane
(``generate.generate``) run eagerly.

``obs=Observability()`` (``repro_torch.obs``) records the reference's
lifecycle events, spans, counters, per-class SLO observations
(``Request.traffic_class``), calibration ledger and health snapshots, at
the reference's decision points and from host state the loops already
hold (the window's tokens after ``CompletionWorker.collect``, the
allocator, the admission lists, the shape-key bookkeeping): recording
reads nothing from the device and sits outside every graphed call, so it
changes no result but the five observability keys.

``faults=ReplicaFaults(...)`` (``serving.faults``, on the continuous stall
loop of either cache) adds the reference's failure-aware serving: the
pre-admission ``shed_pass`` (deadline timeouts and pressure shedding),
straggler slowdowns of the engine clock, and the crash point, which evicts
the active slots and hands every unfinished request to the caller as a
survivor.  ``serve(step_offset=)`` continues a replica's step coordinate
across the failover rounds of ``serving.replica.ReplicatedEngine``.  With
no plan the result carries no fault key.

The vlm and encdec families are served at model level only
(``model.prefill`` / ``decode_step``, ``generate.generate``), as in the
reference, whose engine builds batches of tokens only: the engine
refuses them when it is built (``refuse_frontends``).
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
from ..kvcache import (BlockAllocator, PrefixCache, blocks_for_tokens,
                       window_target_tokens)
from ..kvcache.paged import PagedKVCache
from ..models import model as model_lib, transformer
from ..obs import Observability
from ..obs import log as obslog
from ..obs.metrics import Histogram
from ..prefill import (ChunkScheduler, build_packed_arrays, pack_plans,
                       suffix_shape_key)
from . import generate
from .faults import shed_pass
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
    # traffic class (``core.workload.TrafficClass`` name) the SLO monitor
    # attributes this request to; "" = unclassed (the monitor's default
    # class, and an enqueue event without ``cls``)
    traffic_class: str = ""
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


def _index(i: int) -> np.ndarray:
    """A slot or block id as an executable's (1,) input: it reaches the
    model functions as a device tensor, read by the device only."""
    return np.array([i], np.int32)


def refuse_frontends(cfg) -> None:
    """Raise ``NotImplementedError`` for a config whose prompts need more
    than tokens: a vlm's ``patches``, an encdec's ``frames``.  The
    engine's requests carry text only and its batches hold ``tokens``
    only, as the reference's (src/repro/serving/engine.py:1099, :1141);
    the reference builds such an engine and fails at its first prefill
    (ROADMAP Queue 3 entry R4).  These families are served at model level
    (``model.prefill`` / ``decode_step``, ``generate.generate``)."""
    if cfg.family in ("vlm", "encdec") or cfg.frontend:
        need = "frames" if cfg.family == "encdec" else "patches"
        raise NotImplementedError(
            f"{cfg.name}: the serving engine builds batches of tokens only "
            f"and the {cfg.family!r} family also needs {need}; serve it at "
            "model level (model.prefill / generate.generate; ROADMAP "
            "Queue 3 entry R4)")


class ServingEngine:
    """Single-node engine with a pluggable scheduling policy.

    ``mode="batch"``: ``policy.select`` forms run-to-completion batches.
    ``mode="continuous"``: ``policy.admit`` fills decode slots per window.
    The constructor validates the reference's configuration matrix and
    raises its ``ValueError`` for every invalid row.  ``params`` must live
    on ``device``; ``device=None`` means the card and raises when none is
    present.  On the card the paged attention layers run the CUDA kernels;
    on the CPU they run the reference's plain path (``use_pallas=False``).
    ``aot_warmup=True`` captures the continuous loops' CUDA graphs at
    serve start (``_aot_warm``); with False each key is captured at its
    first call.  Either way the card replays graphs unless the serve runs
    under ``generate.disable_graphs()``.
    """

    def __init__(self, params, cfg, policy: sched_lib.Policy,
                 profile: sched_lib.OfflineProfile, *,
                 input_bucket: int = 32, max_new_tokens: int = 32,
                 xi: float = 2.0, mode: str = "batch",
                 eos_id: int = EOS_ID, kv: str = "contiguous",
                 num_slots: Optional[int] = None,
                 kv_block_size: int = 16,
                 kv_num_blocks: Optional[int] = None,
                 prefill: str = "stall",
                 chunk_size: int = 16,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 decode_steps: int = 1,
                 aot_warmup: bool = True,
                 persist_prefix_cache: bool = False,
                 faults=None, obs: Optional[Observability] = None,
                 device=None):
        # this engine's own fallback ledger (``obslog.scope`` around the
        # serve), as in the reference; no path of the port falls back, so
        # its count stays 0
        self.fallback_ledger = obslog.RateLimitedLogger()
        self.device = resolve_device(device)
        # the reference's validation, in its order and with its messages
        if mode not in ("batch", "continuous"):
            raise ValueError(f"unknown mode {mode!r}")
        if kv not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv layout {kv!r}")
        if kv == "paged" and mode != "continuous":
            raise ValueError('kv="paged" requires mode="continuous"')
        if prefill not in ("stall", "chunked"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if prefill == "chunked" and kv != "paged":
            raise ValueError('prefill="chunked" requires mode="continuous"'
                             ', kv="paged"')
        if prefix_cache and kv != "paged":
            raise ValueError('prefix_cache=True requires mode="continuous"'
                             ', kv="paged"')
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got "
                             f"{decode_steps}")
        if decode_steps > 1 and mode != "continuous":
            raise ValueError('decode_steps > 1 requires mode="continuous" '
                             "(batch mode has no persistent decode loop)")
        if decode_steps - 1 > _MAX_LEN_SLACK:
            raise ValueError(
                f"decode_steps={decode_steps}: the eviction lag "
                f"(decode_steps - 1 overhang writes past a sequence's "
                f"end) exceeds the max_len slack ({_MAX_LEN_SLACK}) that "
                "keeps dead-row writes inside the slot's own KV range")
        if persist_prefix_cache and not prefix_cache:
            raise ValueError("persist_prefix_cache=True requires "
                             "prefix_cache=True")
        if faults is not None and (mode != "continuous"
                                   or prefill != "stall"):
            raise ValueError('faults (serving.faults.ReplicaFaults) '
                             'require mode="continuous", '
                             'prefill="stall"')
        refuse_frontends(cfg)
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
        self.persist_prefix_cache = persist_prefix_cache
        # observability bundle: off by default, every emission site is
        # guarded, and obs=None serves are unchanged
        self.obs = obs
        self.num_slots = (num_slots if num_slots is not None
                          else self.persona.batch_size)
        self.kv_block_size = kv_block_size
        self.prefill = prefill
        self.chunk_size = chunk_size
        self.token_budget = (token_budget if token_budget is not None
                             else self.num_slots + chunk_size)
        if prefill == "chunked":
            ChunkScheduler(chunk_size, self.token_budget)   # validates
        self.use_kernels = self.device.type == "cuda"
        self.kv_num_blocks = (
            kv_num_blocks if kv_num_blocks is not None
            else self.num_slots * blocks_for_tokens(self.max_len,
                                                    kv_block_size))
        if kv == "paged":
            ok, why = transformer.paged_supported(cfg)
            if not ok:
                raise NotImplementedError(f"paged KV cache: {why}")
            worst = blocks_for_tokens(input_bucket + max_new_tokens - 1,
                                      kv_block_size)
            if worst > self.kv_num_blocks:
                raise ValueError(
                    f"kv_num_blocks={self.kv_num_blocks} cannot hold one "
                    f"worst-case sequence ({worst} blocks) — admission "
                    "would deadlock")
        # batch-mode batches run at the policy's max consolidated batch
        # (b * C for UASCHED, C otherwise), padded rows capped at 1 token
        self.batch_capacity = policy.max_batch()
        self.prefix_cache_enabled = prefix_cache
        # the continuous loops' executables and their shape keys (the
        # reference's, engine.py:330-334); their graphs belong to one
        # cache (``_bind_graphs``)
        self.aot_warmup = aot_warmup
        self._aot_dims = (self.num_slots, self.input_bucket, self.max_len,
                          self.kv, self.kv_num_blocks, self.kv_block_size)
        self._window_key = ("window", self._aot_dims, self.decode_steps)
        self._admit_key = ("admit", self._aot_dims)
        self._cow_key = ("cow", self._aot_dims)
        paged = kv == "paged"
        self._window = generate.GraphExecutable(
            model_lib.decode_steps_paged if paged else model_lib.decode_steps,
            "window", self.device)
        self._admit = generate.GraphExecutable(
            model_lib.prefill_into_paged if paged
            else model_lib.prefill_into_slot, "admit", self.device)
        self._cow = generate.GraphExecutable(transformer.copy_paged_block,
                                             "cow", self.device)
        self._ragged = generate.GraphExecutable(model_lib.prefill_chunks,
                                                "ragged", self.device)
        self._graph_cache: Optional[dict] = None
        self.graph_warm_s = 0.0
        self.scheduler_overhead_s = 0.0
        # per-slot ring cache after the last contiguous continuous serve,
        # and the admission audit trail
        self.slot_cache: Optional[dict] = None
        self.admission_log: List[Dict] = []
        self.paged_cache: Optional[PagedKVCache] = None
        self.allocator: Optional[BlockAllocator] = None
        # live PrefixCache of the last serve (prefix_cache=True); rebuilt
        # per serve unless persist_prefix_cache=True
        self.prefix_cache: Optional[PrefixCache] = None
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
        # failure-aware serving (serving.faults.ReplicaFaults): the
        # pre-admission shed pass, straggler slowdowns and the crash point
        # of the continuous stall loop.  The crash latch and the final step
        # coordinate persist across serves: the failover rounds of
        # replica.ReplicatedEngine continue a replica's step stream through
        # serve(step_offset=...), and a crash fires once.
        self.faults = faults
        self._crashed = False
        self.last_step = 0
        self.timed_out_tasks: List[prio.SimTask] = []
        self.shed_tasks: List[prio.SimTask] = []
        self.survivors: List[Request] = []

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
        """Execute a run-to-completion batch (batch mode, or the bulk
        lane); returns its finish time on the engine clock."""
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
        self.prefill_dispatches += 1           # one launch per batch
        if lane == "cpu":
            dur *= self.persona.cpu_slowdown   # bulk-lane emulation
        finish = now + dur
        if self.mode == "batch":
            # the per-iteration trace and the rows used of the batch; in
            # continuous modes both track the decode loop, so a bulk-lane
            # batch counts in the total only
            self.prefill_dispatch_trace.append(1)
            self.kv_util_samples.append(len(batch) / Cb)
            self.peak_concurrency = max(self.peak_concurrency, len(batch))
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
        ob = self.obs
        if ob is not None:
            # the times stamped above: run-to-completion streaming with a
            # uniform ITL over the batch's decode horizon
            ob.inc("prefill.dispatches")
            ob.span("bulk_batch", now, finish - now, lane=lane,
                    size=len(batch))
            for t in batch:
                tid = t.task.task_id
                cls = t.task.traffic_class
                ob.slo_observe("queue_wait", cls, now, t.task.queue_wait_s)
                if t.task.token_times:
                    ob.event("first_token", t.task.token_times[0], tid,
                             lane=lane)
                    ob.slo_observe("ttft", cls, t.task.token_times[0],
                                   t.task.token_times[0] - t.r)
                    if t.task.out_len > 1:
                        ob.slo_observe("itl", cls, finish, dur / horizon,
                                       n=t.task.out_len - 1)
                ob.event("complete", finish, tid, lane=lane,
                         out_len=t.task.out_len)
                ob.inc("sched.completions")
                ob.complete_request(cls, finish, u=t.u,
                                    out_len=t.task.out_len,
                                    latency_s=finish - t.r)
        return finish

    # ------------------------------------------------------------------
    def serve(self, requests: Sequence[Request], *,
              step_offset: int = 0) -> Dict:
        """Run a full trace (virtual-time arrivals, real execution).

        ``step_offset`` starts the step coordinate above zero: the failover
        rounds of ``replica.ReplicatedEngine`` use it so that a replica's
        event stream keeps counting steps where its previous serve stopped
        (the simulator's per-replica step counter never resets)."""
        if step_offset and (self.mode != "continuous"
                            or self.prefill != "stall"):
            raise ValueError("step_offset requires the continuous "
                             "stall serve loop")
        self.timed_out_tasks = []
        self.shed_tasks = []
        self.survivors = []
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
        if not self.persist_prefix_cache:
            # the page pool is rebuilt per serve: cached block ids must
            # not outlive it
            self.prefix_cache = None
        with obslog.scope(self.fallback_ledger):
            self._worker = CompletionWorker(
                metrics=self.obs.metrics if self.obs is not None else None)
            try:
                if self.mode == "continuous":
                    if self.prefill == "chunked":
                        return self._serve_continuous_chunked(requests)
                    return self._serve_continuous(
                        requests, step_offset=step_offset)
                return self._serve_batch(requests)
            finally:
                self._worker.close()
                self._worker = None

    def _result(self, done: List[prio.SimTask], n: int) -> Dict:
        ps = (self.prefix_cache.stats()
              if self.prefix_cache is not None else {})
        # a crashed or fully shed serve can complete nothing: the
        # aggregates give zeros, not NaN
        rts = (np.array([t.response_time for t in done]) if done
               else np.zeros(1))
        span = (max(t.finish for t in done) - min(t.r for t in done)
                if done else 0.0)
        util = (np.array(self.kv_util_samples)
                if self.kv_util_samples else np.zeros(1))
        ob = self.obs
        ttft_h, itl_h, qw_h = Histogram(), Histogram(), Histogram()
        for t in done:
            times = t.task.token_times
            if times:
                ttft_h.record(times[0] - t.r)
                for d in np.diff(times):
                    itl_h.record(float(d))
            if t.task.queue_wait_s >= 0.0:
                qw_h.record(t.task.queue_wait_s)
        out = {
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
            # this engine's own fallback ledger: 0, as nothing falls back
            "fallback_events": self.fallback_ledger.count(),
            # wall seconds the obs emitters spent recording (0.0 without
            # obs), outside the timed device regions
            "obs_overhead_s": ob.overhead_s if ob is not None else 0.0,
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
            "prefix_hit_rate": ps.get("prefix_hit_rate", 0.0),
            "cached_tokens_reused": ps.get("cached_tokens_reused", 0),
            "cow_copies": ps.get("cow_copies", 0),
            "prefix_evictions": ps.get("prefix_evictions", 0),
            "kv": {"kind": self.kv, "num_slots": self.num_slots,
                   "block_size": self.kv_block_size,
                   "num_blocks": self.kv_num_blocks,
                   "prefix_cache": self.prefix_cache_enabled},
            "prefill": {"kind": self.prefill,
                        "chunk_size": self.chunk_size,
                        "token_budget": self.token_budget},
            "pipeline": {"decode_steps": self.decode_steps,
                         "aot_warmup": self.aot_warmup,
                         "persist_prefix_cache": self.persist_prefix_cache,
                         "use_kernels": self.use_kernels},
            "slo_attainment": (ob.slo.attainment()
                               if ob is not None and ob.slo is not None
                               else {}),
            "calibration": (ob.calibration.summary()
                            if ob is not None and ob.calibration is not None
                            else {}),
            "health_trace": list(ob.health_trace) if ob is not None else [],
            "device": str(self.device),
        }
        if self.faults is not None:
            # fault-gated keys: present only when a fault plan is threaded,
            # so an unfaulted result is unchanged
            out["timed_out"] = len(self.timed_out_tasks)
            out["shed"] = len(self.shed_tasks)
            out["timed_out_ids"] = [t.task.task_id
                                    for t in self.timed_out_tasks]
            out["shed_ids"] = [t.task.task_id for t in self.shed_tasks]
            out["crashed"] = self._crashed
            out["final_step"] = self.last_step
            out["survivor_ids"] = [q.task_id for q in self.survivors]
        return out

    def health(self) -> Dict:
        """The latest health snapshot of the current or last serve ({}
        without obs, or before the first snapshot)."""
        return self.obs.health() if self.obs is not None else {}

    def _serve_batch(self, requests: Sequence[Request]) -> Dict:
        """Run-to-completion batches formed by ``policy.select``: a batch
        dispatches when the queue holds a persona batch, its oldest
        request has waited ``xi``, or no request is left to arrive."""
        pending = sorted(requests, key=lambda r: r.arrival)
        sim_tasks = [self._to_sim_task(r) for r in pending]
        queue: List[prio.SimTask] = []
        bulk: List[prio.SimTask] = []
        done: List[prio.SimTask] = []
        now = 0.0
        i = 0
        n = len(sim_tasks)
        C = self.persona.batch_size
        while len(done) < n:
            while i < n and sim_tasks[i].r <= now + 1e-9:
                self._emit_enqueue(sim_tasks[i], None)
                queue.append(sim_tasks[i])
                i += 1
            if queue and (len(queue) >= C
                          or now - min(t.r for t in queue) >= self.xi
                          or i >= n):
                t0 = time.perf_counter()
                gpu_b, cpu_b, rest = self.policy.select(list(queue), now)
                self.scheduler_overhead_s += time.perf_counter() - t0
                queue = list(rest)
                bulk.extend(cpu_b)
                if gpu_b:
                    Cb = self.batch_capacity
                    now = self._run_batch(gpu_b[:Cb], "gpu", now)
                    done.extend(gpu_b[:Cb])
                    queue.extend(gpu_b[Cb:])
                    continue
            if bulk and not queue:
                batch, bulk = bulk[:C], bulk[C:]
                now = self._run_batch(batch, "cpu", now)
                done.extend(batch)
                continue
            # idle: advance to the next arrival / window expiry
            cand = []
            if i < n:
                cand.append(sim_tasks[i].r)
            if queue:
                cand.append(min(t.r for t in queue) + self.xi)
            future = [c for c in cand if c > now]
            if future:
                now = min(future)
            else:
                now += self.xi
        return self._result(done, n)

    # ------------------------------------------------------------------
    # continuous batching: persistent decode loop with slot recycling
    # ------------------------------------------------------------------

    def _extend_block_tables(self, active, slot_task, slot_gen, slot_cap,
                             alloc, kvc, steps: int) -> None:
        """Before a paged decode window, extend each active slot's table to
        cover every useful write of the next ``steps`` steps
        (``window_target_tokens``, clamped at the admission reservation);
        overhang writes past the clamp land on the trash page.  Shared by
        the stall and chunked serve loops."""
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
                               done, *, alloc=None, kvc=None,
                               reserved=None, step: int = 0) -> None:
        """Window-end (in-arrears) bookkeeping, shared by the stall and
        chunked serve loops: consume the (C, n) window tokens step-major,
        record each with its interpolated emission time, finish sequences
        at their EOS/cap step, and evict the finished ones, in slot order,
        only after the whole window is consumed (the eviction-lag
        invariant).  ``alloc``/``kvc``/``reserved``: the paged pool's
        state, whose blocks eviction returns (None on the contiguous
        cache).  ``step``: the decode steps executed so far, the events'
        iteration coordinate."""
        ob = self.obs
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
                prev_t = task.task.token_times[-1]
                task.task.out_tokens.append(tok)
                task.task.token_times.append(t_j)
                if ob is not None:
                    ob.event("token", t_j, task.task.task_id, step,
                             slot=s, idx=slot_gen[s])
                    ob.slo_observe("itl", task.task.traffic_class, t_j,
                                   t_j - prev_t)
                if tok == self.eos_id or slot_gen[s] >= slot_cap[s]:
                    task.finish = t_j
                    task.task.finish = t_j
                    task.task.out_len = slot_gen[s]
                    done.append(task)
                    finished.append(s)
                    if ob is not None:
                        self._emit_complete(task, t_j, step, slot_gen[s])
                        # eviction lag: window steps this slot's blocks
                        # stay held past its logical end (in arrears)
                        ob.observe("decode.eviction_lag_steps", n - 1 - j)
                else:
                    tokens[s, 0] = tok
        for s in active:
            if s not in finished:
                continue
            tid = slot_task[s].task.task_id
            slot_task[s] = None
            tokens[s, 0] = generate.PAD_ID
            if ob is not None:
                ob.event("evict", now, tid, step, slot=s)
            if alloc is not None:
                alloc.free_sequence(tid)
                kvc.clear_table(s)
                reserved[s] = 0

    def _paged_setup(self):
        """Build, or with ``persist_prefix_cache=True`` revive, the paged
        serve state: the page pool on the device, the host allocator and
        the prefix cache.  On the persistent path the pool's cached blocks
        keep their K/V across serves (every decode slot was evicted at the
        previous serve's end, so only cache-pinned blocks are live) and
        the index keeps its entries while its per-serve counters reset."""
        mreg = self.obs.metrics if self.obs is not None else None
        if (self.persist_prefix_cache and self.paged_cache is not None
                and self.prefix_cache is not None):
            self.prefix_cache.reset_stats()
            # the "prefix.*" counters go to this serve's registry
            self.prefix_cache.metrics = mreg
            return self.paged_cache, self.allocator, self.prefix_cache
        kvc = PagedKVCache(self.cfg, self.num_slots, self.kv_num_blocks,
                           self.kv_block_size, self.max_len,
                           device=self.device)
        alloc = BlockAllocator(self.kv_num_blocks, self.kv_block_size)
        self.paged_cache, self.allocator = kvc, alloc
        pc = None
        if self.prefix_cache_enabled:
            pc = PrefixCache(alloc, self.kv_block_size)
            pc.metrics = mreg
            self.prefix_cache = pc
        return kvc, alloc, pc

    def _executables(self) -> Dict[str, generate.GraphExecutable]:
        return {"window": self._window, "admit": self._admit,
                "cow": self._cow, "ragged": self._ragged}

    def _ragged_key(self, shape_key: tuple) -> tuple:
        return ("ragged", self._aot_dims, shape_key)

    def _bind_graphs(self, cache: dict, kvc=None) -> None:
        """Hand the serve's cache to the executables, then warm them.
        Their graphs read its storage: a new cache object drops every
        graph (and their pool) and the warm-up captures anew; the same
        cache (``persist_prefix_cache``) keeps its graphs across serves.
        The executables' counters restart with every serve."""
        fresh = cache is not self._graph_cache
        pool = (torch.cuda.graph_pool_handle()
                if fresh and self._window.captures() else None)
        for ex in self._executables().values():
            if fresh:
                ex.reset(pool)
            ex.replays, ex.capture_s = 0, 0.0
        self._graph_cache = cache
        self._aot_warm(cache, kvc)

    def _aot_warm(self, cache: dict, kvc=None) -> None:
        """Capture the continuous loops' graphs at serve start, the
        reference's ``_aot_warm`` (engine.py:893-963): the N-step decode
        window, the stall admission, the copy-on-write page copy (prefix
        cache) and the fused ragged keys a serve opens with -- every
        reachable uncached-suffix length of a stall serve with the prefix
        cache (matches are block-quantized, plus the one-token recompute
        of a full match), ``{min(chunk, S), S}`` of a chunked one.  Other
        ragged keys are captured on their first call.  Records the
        warm-up's seconds (``graph_warm_s``).  A capture that fails
        raises."""
        self.graph_warm_s = 0.0
        if not self.aot_warmup or not self._window.captures():
            return
        C, S, n = self.num_slots, self.input_bucket, self.decode_steps
        p, cfg = self.params, self.cfg

        def z(*shape):              # example inputs: only shapes are read
            return np.zeros(shape, np.int32)

        t0 = time.perf_counter()
        if self.kv == "paged":
            nb = kvc.max_blocks_per_seq
            self._window.warm(self._window_key, (p, cfg, cache, z(C, 1),
                                                 z(C, nb)),
                              {"num_steps": n,
                               "use_kernels": self.use_kernels})
            if self.prefill == "stall":
                self._admit.warm(self._admit_key,
                                 (p, cfg, cache, z(1, S), z(1), z(nb)),
                                 {"max_len": self.max_len})
            lens: set = set()
            if self.prefix_cache_enabled:
                self._cow.warm(self._cow_key, (cache, z(1), z(1)))
                if self.prefill == "stall":
                    bs = self.kv_block_size
                    lens |= {S - k * bs for k in range(1, S // bs + 1)
                             if S - k * bs > 0} | {1}
            if self.prefill == "chunked":
                lens |= {min(self.chunk_size, S), S}
            for L in sorted(lens):
                key = suffix_shape_key(L)
                TTp, Cp, Tp = key
                self._ragged.warm(self._ragged_key(key),
                                  (p, cfg, cache, z(1, TTp), z(TTp),
                                   z(Cp, 4), z(Cp, nb)),
                                  {"chunk_pad": Tp,
                                   "use_kernels": self.use_kernels})
        else:
            self._window.warm(self._window_key, (p, cfg, cache, z(C, 1)),
                              {"num_steps": n})
            self._admit.warm(self._admit_key, (p, cfg, cache, z(1, S), z(1)),
                             {"max_len": self.max_len})
        self.graph_warm_s = time.perf_counter() - t0

    def graph_stats(self) -> Dict:
        """The last continuous serve's graphs per executable (the keys
        captured), their replays, the seconds spent capturing (warm-up and
        first calls), and the warm-up's seconds."""
        ex = self._executables()
        return {"graphs": {k: len(e.aot) for k, e in ex.items()},
                "replays": {k: e.replays for k, e in ex.items()},
                "capture_s": sum(e.capture_s for e in ex.values()),
                "warm_s": self.graph_warm_s}

    def _exec_key_seen(self, key: tuple) -> bool:
        """Count a fused prefill launch's padded shape key as an
        executable-cache hit or miss (the reference's jit memo, mirrored
        by the simulator); returns whether it was a hit.  The shape-key
        bookkeeping alone decides, never whether a graph was captured, so
        the CPU and the card count alike."""
        hit = key in self._exec_keys
        if hit:
            self.exec_cache_hits += 1
        else:
            self._exec_keys.add(key)
            self.exec_cache_misses += 1
        return hit

    def _prefix_admit(self, cache, kvc, alloc, pc, slot: int, tid: int,
                      toks: np.ndarray):
        """Stall admission with the prefix cache: share the matched
        blocks, copy-on-write a fully matched last block, prefill only the
        uncached suffix (a miss prefills the whole prompt), then index the
        fresh blocks.  Returns the last position's logits (V,), the
        admission plan, and for a suffix launch its shape key and whether
        that was an executable-cache hit (None for a whole prompt)."""
        S = self.input_bucket
        plan = pc.admit(tid, toks)
        kvc.set_table(slot, alloc.table(tid))
        for src, dst in plan.cow:
            self._cow.call_aot(self._cow_key, cache, _index(src),
                               _index(dst))
        suffix = None
        if plan.start == 0:
            last_logits = self._admit.call_aot(
                self._admit_key, self.params, self.cfg, cache, toks[None],
                _index(slot), kvc.tables[slot], max_len=self.max_len)
        else:
            # the uncached suffix as a single-chunk fused launch
            key = suffix_shape_key(S - plan.start)
            suffix = (key, self._exec_key_seen(key))
            tokens_arr, token_chunk, meta, tabs = build_packed_arrays(
                key, [(slot, plan.start, toks[plan.start:],
                       alloc.table(tid))],
                pad_slot=self.num_slots,
                table_width=kvc.max_blocks_per_seq,
                trash_block=kvc.trash_block)
            last_logits = self._ragged.call_aot(
                self._ragged_key(key), self.params, self.cfg, cache,
                tokens_arr, token_chunk, meta, tabs, chunk_pad=key[2],
                use_kernels=self.use_kernels)[0]
        pc.commit(tid, toks)
        return last_logits, plan, suffix

    # -- observability: emission blocks shared by the serve loops, each a
    # no-op without obs; the order inside each is the reference's
    def _emit_enqueue(self, task: prio.SimTask, step) -> None:
        if self.obs is not None:
            cls = task.task.traffic_class
            self.obs.event("enqueue", task.r, task.task.task_id, step,
                           **({"cls": cls} if cls else {}))

    def _emit_offload(self, task: prio.SimTask, now: float,
                      step: int) -> None:
        if self.obs is not None:
            self.obs.event("offload", now, task.task.task_id, step)
            self.obs.inc("sched.offloads")

    def _emit_reject(self, task: prio.SimTask, now: float, step: int,
                     need: int) -> None:
        if self.obs is not None:
            self.obs.event("reject", now, task.task.task_id, step,
                           kv_blocks=need)
            self.obs.inc("sched.rejections")

    def _emit_admit(self, task: prio.SimTask, now: float, step: int,
                    slot: int, need: int) -> None:
        ob = self.obs
        if ob is not None:
            ob.event("admit", now, task.task.task_id, step, slot=slot,
                     u=task.u, kv_blocks=need)
            ob.inc("sched.admissions")
            ob.observe("queue_wait_s", task.task.queue_wait_s)
            ob.slo_observe("queue_wait", task.task.traffic_class, now,
                           task.task.queue_wait_s)

    def _emit_prefix_hit(self, plan, now: float, tid: int,
                         step: int) -> None:
        if self.obs is not None and plan.matched_blocks:
            self.obs.event("prefix_hit", now, tid, step,
                           cached_tokens=plan.start,
                           matched_blocks=plan.matched_blocks,
                           cow=len(plan.cow))

    def _emit_exec_cache(self, now: float, tid, step: int, hit: bool,
                         key: tuple) -> None:
        if self.obs is not None:
            self.obs.event("exec_cache", now, tid, step, hit=hit,
                           shape_key=str(key))
            self.obs.inc("exec_cache.hits" if hit else "exec_cache.misses")

    def _emit_first_token(self, task: prio.SimTask, now: float, step: int,
                          slot: int) -> None:
        if self.obs is not None:
            self.obs.event("first_token", now, task.task.task_id, step,
                           slot=slot)
            self.obs.slo_observe("ttft", task.task.traffic_class, now,
                                 now - task.r)

    def _emit_complete(self, task: prio.SimTask, t: float, step: int,
                       out_len: int, evict_slot: Optional[int] = None
                       ) -> None:
        """A finished request: ``complete`` (and ``evict`` when it frees
        its slot at once), the completion counter, and its SLO and
        calibration records."""
        ob = self.obs
        if ob is None:
            return
        tid = task.task.task_id
        ob.event("complete", t, tid, step, lane="gpu", out_len=out_len)
        if evict_slot is not None:
            ob.event("evict", t, tid, step, slot=evict_slot)
        ob.inc("sched.completions")
        ob.complete_request(task.task.traffic_class, t, u=task.u,
                            out_len=out_len, latency_s=t - task.r)

    def _emit_window(self, now: float, dt: float, step: int, nsteps: int,
                     active: int) -> None:
        """A decode window's counters, the KV utilization gauge and
        counter sample, its span and its event (``dur`` = the measured
        ``dt``)."""
        ob = self.obs
        if ob is not None:
            util = self.kv_util_samples[-1]
            ob.inc("decode.dispatches")
            ob.inc("decode.steps", nsteps)
            ob.gauge("kv.util", util)
            ob.counter_sample("kv.util", now, util)
            ob.span("decode.window", now - dt, dt, steps=nsteps,
                    active=active)
            ob.event("decode_window", now, None, step, steps=nsteps,
                     active=active, dur=dt)

    def _snapshot(self, now: float, step: int, queue, slot_task) -> None:
        """The periodic health snapshot after a window's bookkeeping, its
        ``wall`` field the pipeline's collect waits so far."""
        if self.obs is not None:
            self.obs.maybe_snapshot(
                now, step, queue_depth=len(queue),
                active=sum(t is not None for t in slot_task),
                kv_util=self.kv_util_samples[-1],
                wall={"collect_wait": self._worker.wait_snapshot()})

    def _serve_continuous(self, requests: Sequence[Request], *,
                          step_offset: int = 0) -> Dict:
        """Continuous serve with stall admission, on the contiguous
        per-slot ring cache or the paged pool.

        Each iteration fills the free slots (one ``policy.admit`` call and
        one full prefill of the admitted prompt per slot, the decode loop
        stalled meanwhile), then runs one N-step decode window over all
        slots.  With a fault plan, an iteration first checks the crash
        point and then runs ``shed_pass`` over the queue, and a window's
        ``dt`` is stretched by the plan's slowdown."""
        C = self.num_slots
        S = self.input_bucket
        ob = self.obs
        rf = self.faults
        paged = self.kv == "paged"
        pending = sorted(requests, key=lambda r: r.arrival)
        sim_tasks = [self._to_sim_task(r) for r in pending]
        n = len(sim_tasks)
        queue: List[prio.SimTask] = []
        bulk: List[prio.SimTask] = []
        done: List[prio.SimTask] = []
        pc = kvc = alloc = reserved = None
        if paged:
            kvc, alloc, pc = self._paged_setup()
            cache = kvc.state
            reserved = [0] * C       # per-slot worst-case block holdback
        else:
            cache = transformer.init_slot_cache(self.cfg, C, self.max_len,
                                                device=self.device)
        self._bind_graphs(cache, kvc)
        slot_task: List[Optional[prio.SimTask]] = [None] * C
        slot_gen = [0] * C
        slot_cap = [0] * C
        tokens = np.zeros((C, 1), np.int32)     # host copy of next tokens
        self.admission_log = []
        now = 0.0
        i = 0
        step = step_offset
        while (len(done) + len(self.timed_out_tasks)
               + len(self.shed_tasks)) < n:
            if (rf is not None and rf.crash_at_step is not None
                    and not self._crashed and step >= rf.crash_at_step):
                # replica death (serving.faults.CrashFault): evict the
                # active slots in slot order (freeing their blocks), then
                # every unfinished request -- active, queued, bulk lane,
                # not yet arrived -- survives for the fault coordinator
                # to re-dispatch (the simulator's _ReplicaSim.crash())
                crash_surv: List[prio.SimTask] = []
                for slot in range(C):
                    t = slot_task[slot]
                    if t is None:
                        continue
                    if ob is not None:
                        ob.event("evict", now, t.task.task_id, step,
                                 slot=slot)
                    if paged:
                        alloc.free_sequence(t.task.task_id)
                        kvc.clear_table(slot)
                        reserved[slot] = 0
                    slot_task[slot] = None
                    crash_surv.append(t)
                crash_surv += list(queue) + list(bulk) + sim_tasks[i:]
                queue, bulk = [], []
                self._crashed = True
                self.survivors = [t.task for t in crash_surv]
                if ob is not None:
                    ob.event("replica_down", now, None, step,
                             reason="crash", survivors=len(crash_surv))
                    ob.inc("faults.replica_down")
                break
            while i < n and sim_tasks[i].r <= now + 1e-9:
                self._emit_enqueue(sim_tasks[i], step)
                queue.append(sim_tasks[i])
                i += 1
            if rf is not None and queue:
                # the pre-admission pass (serving.faults): doomed-request
                # timeouts, then pressure shedding -- the simulator's
                # iterate() makes the same call at the same point
                queue, timed, dropped = shed_pass(
                    queue, now=now, step=step, rf=rf,
                    slo=ob.slo if ob is not None else None, obs=ob)
                self.timed_out_tasks += timed
                self.shed_tasks += dropped
            iter_stall = 0.0
            iter_launches = 0

            # --- admissions: fill freed slots, one policy call per slot
            while queue and None in slot_task:
                running = [t for t in slot_task if t is not None]
                prev_queue = list(queue)
                t0 = time.perf_counter()
                task, lane, rest = self.policy.admit(list(queue), now,
                                                     running)
                self.scheduler_overhead_s += time.perf_counter() - t0
                if task is None:
                    break
                queue = list(rest)
                if lane == "cpu":
                    self._emit_offload(task, now, step)
                    bulk.append(task)
                    continue
                cap = self._cap(task.task)
                need = 0
                if paged:
                    # worst-case reservation gate (the simulator's
                    # block-budget model mirrors it bit for bit)
                    need = blocks_for_tokens(S + cap - 1,
                                             self.kv_block_size)
                    if need > self.kv_num_blocks - sum(reserved):
                        queue = prev_queue       # leave it queued
                        self._rejected_ids.add(task.task.task_id)
                        self._emit_reject(task, now, step, need)
                        break
                slot = slot_task.index(None)
                if paged:
                    reserved[slot] = need
                tid = task.task.task_id
                task.task.queue_wait_s = now - task.r
                self._emit_admit(task, now, step, slot, need)
                stalled = any(t is not None for t in slot_task)
                toks = self._tokenize_padded(task.task.text)
                plan = suffix = None
                t0 = time.perf_counter()
                if pc is not None:
                    last_logits, plan, suffix = self._prefix_admit(
                        cache, kvc, alloc, pc, slot, tid, toks)
                elif paged:
                    kvc.set_table(slot, alloc.allocate_n(
                        tid, alloc.blocks_for(S)))
                    last_logits = self._admit.call_aot(
                        self._admit_key, self.params, self.cfg, cache,
                        toks[None], _index(slot), kvc.tables[slot],
                        max_len=self.max_len)
                else:
                    last_logits = self._admit.call_aot(
                        self._admit_key, self.params, self.cfg, cache,
                        toks[None], _index(slot), max_len=self.max_len)
                first = int(torch.argmax(last_logits))
                dt = time.perf_counter() - t0
                now += dt
                self.prefill_dispatches += 1   # one launch per admission
                iter_launches += 1
                if stalled:       # live slots waited out this prefill
                    self.prefill_stall_s += dt
                    iter_stall += dt
                if ob is not None:
                    # after the timed launch, so recording never lands on
                    # the engine clock; the reference's order
                    pf_start, pf_key = 0, "admit"
                    if plan is not None:
                        self._emit_prefix_hit(plan, now, tid, step)
                    if suffix is not None:
                        pf_start, pf_key = plan.start, str(suffix[0])
                        self._emit_exec_cache(now, tid, step, suffix[1],
                                              suffix[0])
                    ob.inc("prefill.dispatches")
                    ob.span("prefill.admit", now - dt, dt, task=tid,
                            slot=slot)
                    ob.event("prefill_chunk", now, tid, step, slot=slot,
                             start=pf_start, length=S - pf_start,
                             finishes=True, shape_key=pf_key)
                    self._emit_first_token(task, now, step, slot)
                task.start, task.lane = now, "gpu"
                task.task.start, task.task.lane = now, "gpu"
                task.task.slot = slot
                task.task.out_tokens = [first]
                task.task.token_times = [now]
                self.admission_log.append(
                    {"task_id": tid, "slot": slot, "step": step,
                     "now": now})
                if first == self.eos_id or cap <= 1:
                    task.finish = now
                    task.task.finish, task.task.out_len = now, 1
                    done.append(task)
                    self._emit_complete(task, now, step, 1, evict_slot=slot)
                    if paged:
                        alloc.free_sequence(tid)
                        kvc.clear_table(slot)
                        reserved[slot] = 0
                else:
                    slot_task[slot] = task
                    slot_gen[slot], slot_cap[slot] = 1, cap
                    tokens[slot, 0] = first

            self.prefill_stall_max_s = max(self.prefill_stall_max_s,
                                           iter_stall)
            if iter_launches:
                self.prefill_dispatch_trace.append(iter_launches)
            active = [s for s in range(C) if slot_task[s] is not None]
            if active:
                self.peak_concurrency = max(self.peak_concurrency,
                                            len(active))
                # --- one N-step decode WINDOW over ALL slots
                nsteps = self.decode_steps
                t0 = time.perf_counter()
                if paged:
                    self._extend_block_tables(active, slot_task, slot_gen,
                                              slot_cap, alloc, kvc, nsteps)
                    window_tok = self._window.call_aot(
                        self._window_key, self.params, self.cfg, cache,
                        tokens, kvc.tables, num_steps=nsteps,
                        use_kernels=self.use_kernels)
                else:
                    window_tok = self._window.call_aot(
                        self._window_key, self.params, self.cfg, cache,
                        tokens, num_steps=nsteps)
                self._worker.submit(window_tok, t0)
                window_host, dt = self._worker.collect()
                if rf is not None:
                    # straggler fault (SlowFault): stretch the window's
                    # charge to the engine clock; parity streams carry no
                    # time field
                    dt *= rf.slow_factor(step)
                now += dt
                step += nsteps
                self.decode_dispatches += 1
                self.decode_steps_total += nsteps
                self.decode_dispatch_trace.append(nsteps)
                self.kv_util_samples.append(
                    alloc.utilization() if paged else len(active) / C)
                self._emit_window(now, dt, step, nsteps, len(active))
                self._advance_decode_window(
                    active, window_host, now, dt, slot_task, slot_gen,
                    slot_cap, tokens, done, alloc=alloc, kvc=kvc,
                    reserved=reserved, step=step)
                self._snapshot(now, step, queue, slot_task)
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
        if not paged:
            self.slot_cache = cache
        self.last_step = step
        return self._result(done, n)

    def _serve_continuous_chunked(self, requests: Sequence[Request]) -> Dict:
        """Continuous serve with chunked prefill over the paged pool.

        Admission allocates a slot plus the prompt's blocks (with the
        prefix cache: shares the cached prefix, and the job covers only
        the uncached suffix) and enqueues a chunk job; each iteration packs the token budget (decode tokens
        first, then prefill chunks in the policy's priority order), runs
        the whole plan as ONE fused ragged launch, then one N-step decode
        window over all slots."""
        C = self.num_slots
        S = self.input_bucket
        ob = self.obs
        pending = sorted(requests, key=lambda r: r.arrival)
        sim_tasks = [self._to_sim_task(r) for r in pending]
        n = len(sim_tasks)
        queue: List[prio.SimTask] = []
        bulk: List[prio.SimTask] = []
        done: List[prio.SimTask] = []
        kvc, alloc, pc = self._paged_setup()
        cache = kvc.state
        self._bind_graphs(cache, kvc)
        reserved = [0] * C           # per-slot worst-case block holdback
        sched = ChunkScheduler(self.chunk_size, self.token_budget,
                               metrics=ob.metrics if ob is not None
                               else None)
        slot_task: List[Optional[prio.SimTask]] = [None] * C  # decoding
        slot_gen = [0] * C
        slot_cap = [0] * C
        job_cap: Dict[int, int] = {}            # slot -> decode cap
        job_tokens: Dict[int, np.ndarray] = {}  # slot -> padded prompt
        job_row: Dict[int, np.ndarray] = {}     # slot -> host table row
        job_start: Dict[int, int] = {}          # slot -> cached prefix
        tokens = np.zeros((C, 1), np.int32)
        self.admission_log = []
        now = 0.0
        i = 0
        step = 0
        while len(done) < n:
            while i < n and sim_tasks[i].r <= now + 1e-9:
                self._emit_enqueue(sim_tasks[i], step)
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
                    self._emit_offload(task, now, step)
                    bulk.append(task)
                    continue
                cap = self._cap(task.task)
                need = blocks_for_tokens(S + cap - 1, self.kv_block_size)
                if need > self.kv_num_blocks - sum(reserved):
                    queue = prev_queue           # leave it queued
                    self._rejected_ids.add(task.task.task_id)
                    self._emit_reject(task, now, step, need)
                    break
                slot = free.pop(0)
                reserved[slot] = need
                task.task.queue_wait_s = now - task.r
                self._emit_admit(task, now, step, slot, need)
                # all of the prompt's blocks up front; the slot's DECODE
                # table row stays on the trash page until prefill
                # completes (the decode step writes every row)
                toks = self._tokenize_padded(task.task.text)
                start = 0
                if pc is not None:
                    # matched prefix blocks are shared into the table;
                    # the chunk job covers only the uncached suffix
                    plan = pc.admit(task.task.task_id, toks)
                    start = plan.start
                    self._emit_prefix_hit(plan, now, task.task.task_id, step)
                    for src, dst in plan.cow:
                        self._cow.call_aot(self._cow_key, cache,
                                           _index(src), _index(dst))
                else:
                    alloc.allocate_n(task.task.task_id, alloc.blocks_for(S))
                row = np.full((kvc.max_blocks_per_seq,), kvc.trash_block,
                              np.int32)
                tbl = alloc.table(task.task.task_id)
                row[:len(tbl)] = tbl
                job_row[slot] = row
                job_tokens[slot] = toks
                job_start[slot] = start
                job_cap[slot] = cap
                sched.add(task, slot, S - start,
                          self.policy.assign_priority(task))
                self.admission_log.append(
                    {"task_id": task.task.task_id, "slot": slot,
                     "step": step, "now": now})

            # --- chunk phase: the whole plan as one fused ragged launch
            iter_stall = 0.0
            active0 = [s for s in range(C) if slot_task[s] is not None]
            plans = sched.schedule(len(active0)) if sched.has_jobs else []
            batch_plan = pack_plans(plans)
            if batch_plan is not None:
                key = batch_plan.shape_key
                self._emit_exec_cache(now, None, step,
                                      self._exec_key_seen(key), key)
                # chunk offsets are relative to the job (the uncached
                # suffix); job_start shifts them to prompt positions
                entries = []
                for ch in batch_plan.chunks:
                    base = job_start[ch.slot] + ch.start
                    entries.append((ch.slot, base,
                                    job_tokens[ch.slot][base:
                                                        base + ch.length],
                                    job_row[ch.slot]))
                tokens_arr, token_chunk, meta, tabs = build_packed_arrays(
                    key, entries, pad_slot=C,
                    table_width=kvc.max_blocks_per_seq,
                    trash_block=kvc.trash_block)
                stalled = any(t is not None for t in slot_task)
                t0 = time.perf_counter()
                last_logits = self._ragged.call_aot(
                    self._ragged_key(key), self.params, self.cfg, cache,
                    tokens_arr, token_chunk, meta, tabs,
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
                if ob is not None:
                    ob.inc("prefill.dispatches")
                    ob.span("prefill.ragged", now - dt, dt,
                            chunks=len(batch_plan.chunks),
                            tokens=batch_plan.total_tokens)
                    for ch in batch_plan.chunks:
                        ob.event("prefill_chunk", now,
                                 ch.job.task.task.task_id, step,
                                 slot=ch.slot, start=ch.start,
                                 length=ch.length, finishes=ch.finishes,
                                 shape_key=str(key))
                for ci, ch in enumerate(batch_plan.chunks):
                    if not ch.finishes:
                        continue
                    s = ch.slot
                    task = ch.job.task
                    first = int(next_ids[ci])
                    if pc is not None:
                        pc.commit(task.task.task_id, job_tokens[s])
                    cap = job_cap.pop(s)
                    del job_tokens[s], job_row[s], job_start[s]
                    task.start, task.lane = now, "gpu"
                    task.task.start, task.task.lane = now, "gpu"
                    task.task.slot = s
                    task.task.out_tokens = [first]
                    task.task.token_times = [now]
                    self._emit_first_token(task, now, step, s)
                    if first == self.eos_id or cap <= 1:
                        task.finish = now
                        task.task.finish, task.task.out_len = now, 1
                        done.append(task)
                        self._emit_complete(task, now, step, 1, evict_slot=s)
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
                window_tok = self._window.call_aot(
                    self._window_key, self.params, self.cfg, cache, tokens,
                    kvc.tables, num_steps=nsteps,
                    use_kernels=self.use_kernels)
                self._worker.submit(window_tok, t0)
                window_host, dt = self._worker.collect()
                now += dt
                step += nsteps
                self.decode_dispatches += 1
                self.decode_steps_total += nsteps
                self.kv_util_samples.append(alloc.utilization())
                self._emit_window(now, dt, step, nsteps, len(active))
                self._advance_decode_window(
                    active, window_host, now, dt, slot_task, slot_gen,
                    slot_cap, tokens, done, alloc=alloc, kvc=kvc,
                    reserved=reserved, step=step)
                self._snapshot(now, step, queue, slot_task)
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
