"""Discrete-event simulator of the serving node (GPU lane + CPU lane):
a copy of ``repro.core.simulator`` (framework-free, pure host Python)
over the port's own copies of the allocator, the prefix cache, the chunk
packer, the metrics' ``Histogram``, the router and the fault machinery.
``tests/test_torch_simulator.py`` holds it to the reference bit for bit;
ROADMAP Queue 3 entries R1 and R2 are the reference's behaviour and are
kept as such.

Execution-time model, calibrated to the paper's published coefficients
(personas.py) and cross-checked against the port's engine on tiny
configs (tests/test_torch_engine*.py hold the engine to the reference's
copy of this model):

    t_batch(GPU) = setup_f + eta_f * max(out_len in batch)
    t_batch(CPU) = cpu_slowdown_f * t_batch(GPU-model)

Batched autoregressive decoding runs until its *longest* member finishes
— this is precisely the head-of-line effect RT-LM's consolidation
exploits: batches with homogeneous output lengths waste no decode steps.

The simulator owns the clock; the policy is consulted whenever the GPU
lane is free and the dispatch condition holds (>= C queued, or the oldest
task has waited the xi batching window).  The CPU lane drains offloaded
tasks independently.

Two execution models, cross-checkable against the real engine:

  * ``simulate``            — run-to-completion batches (paper model).
  * ``simulate_continuous`` — iteration-level batching: C decode slots,
    finished sequences evicted per step, the policy's ``admit`` consulted
    per freed slot.  Per-step cost model: eta per decode step (the
    decode loop is latency-bound, independent of slot occupancy),
    item_time per admission (the per-member bandwidth term the batch
    model charges once per batch), setup_time only when the engine
    restarts from idle.  Admission is modeled as AMORTIZED prefill: the
    first token materializes at admission without an eta charge, so a
    saturated homogeneous wave costs setup + (L-1)*eta + C*item — one
    eta LESS than the batch model's linear fit (setup + L*eta + C*item),
    which folds the prefill-emitted first token into eta*L.  This is a
    deliberate idealization (real continuous engines chunk/overlap
    prefill; ours serializes it and still wins — see the wall-clock
    benchmark in benchmarks/continuous_vs_batch.py, the unbiased check);
    beyond that one amortized step per wave, continuous batching's
    advantage comes from eliminating head-of-line blocking and the xi
    dispatch wait.

The continuous state machine lives in ``_ReplicaSim`` — one replica's
slots, queues, KV reservations and clock behind ``deliver`` / ``iterate``
/ ``advance_idle``.  ``simulate_continuous`` drives exactly one instance
(the single-node model, bit-identical to the pre-factoring loop);
``simulate_replicated`` drives R instances behind a front-end
``repro_torch.serving.router.Router`` on a shared virtual clock — the
simulator twin of ``repro_torch.serving.replica.ReplicatedEngine``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..kvcache import (BlockAllocator, PrefixCache, blocks_for_tokens,
                           window_target_tokens)
from ..obs.metrics import Histogram
from ..prefill import ChunkScheduler, pack_plans, suffix_shape_key

from . import scheduler as sched_lib
from .personas import Persona
from .priority import SimTask


def _pct(samples, q: float) -> float:
    return float(np.quantile(np.asarray(samples), q)) if len(samples) \
        else 0.0


def _tid(t: SimTask):
    """Event task id: the wrapped request's task_id when present (the
    engine stamps the same id, which is what makes event streams
    comparable), else None."""
    return getattr(getattr(t, "task", None), "task_id", None)


def _cls(t: SimTask) -> str:
    """Traffic class of the wrapped request ("" when unclassed) — the
    same attribute the engine reads (Request.traffic_class)."""
    return getattr(getattr(t, "task", None), "traffic_class", "") or ""


@dataclasses.dataclass
class SimResult:
    tasks: List[SimTask]
    makespan: float
    overhead_s: float = 0.0
    # block-budget admission model (continuous mode with a paged KV
    # cache): engine-side mirrors in ServingEngine._result
    kv_rejected: int = 0
    kv_util_peak: float = 0.0
    kv_util_mean: float = 0.0
    peak_concurrency: int = 0
    # tail-latency metrics (engine-side mirrors in _result): TTFT per
    # task, pooled inter-token latencies — p99 ITL is where stall
    # prefill shows up as decode jitter.  batch mode models streaming
    # linearly across the batch's decode horizon.  All percentile
    # fields come from ``repro_torch.obs.metrics.Histogram`` (log-bucketed
    # streaming state — the same substrate the engine's _result uses),
    # so they are estimates within one bucket's relative width
    # (~2.5%) of the exact order statistic.
    ttft_p50: float = 0.0
    ttft_p90: float = 0.0
    ttft_p99: float = 0.0
    itl_p50: float = 0.0
    itl_p90: float = 0.0
    itl_p99: float = 0.0
    # per-request time from arrival to admission (bulk lane: batch
    # start) — engine mirror stamps Request.queue_wait_s
    queue_wait_p50: float = 0.0
    queue_wait_p90: float = 0.0
    queue_wait_p99: float = 0.0
    # engine mirror counts rate-limited kernel/warmup fallbacks
    # (repro_torch.obs.log); the simulator runs no kernels, so always 0 —
    # kept so result dicts stay field-compatible
    fallback_events: int = 0
    # chunked-prefill mode: per-iteration (decode_tokens,
    # prefill_tokens) — the engine records the identical trace
    budget_trace: List = dataclasses.field(default_factory=list)
    # dispatch accounting (engine-side mirrors in _result): total
    # prefill launches and per-iteration launch counts — the fused
    # chunked engine issues exactly ONE launch per iteration with
    # scheduled chunks (trace aligned with budget_trace, entries <= 1);
    # stall mode records admission-burst sizes; batch mode one launch
    # per executed batch.  exec_cache_* mirror the engine's fused
    # executable padded-shape-key novelty (ChunkBatch.shape_key via
    # the SAME pack_plans call, so parity is straight equality).
    prefill_dispatches: int = 0
    prefill_dispatch_trace: List = dataclasses.field(default_factory=list)
    exec_cache_hits: int = 0
    exec_cache_misses: int = 0
    # prefix-cache model (kvcache.prefix driven host-side, the same
    # class the engine drives): counter definitions match
    # ServingEngine._result field for field, so parity on the
    # hit/CoW/eviction numbers is straight equality
    prefix_hit_rate: float = 0.0
    cached_tokens_reused: int = 0
    cow_copies: int = 0
    prefix_evictions: int = 0
    # decode-dispatch accounting (async host pipeline mirror of the
    # engine's multi-step decode window): launches, total steps
    # (steps/dispatches == decode_steps exactly) and steps per window
    # (chunked mode aligns entries with budget_trace, 0 = prefill-only
    # iteration) — all three parity-match ServingEngine._result.
    decode_dispatches: int = 0
    decode_steps_executed: int = 0
    decode_dispatch_trace: List = dataclasses.field(default_factory=list)
    # SLO monitoring / predictor calibration / health snapshots (
    # engine mirrors in ServingEngine._result): {} / [] with the
    # features off; the deterministic members (per-class counts,
    # calibration counters, non-wall snapshot fields) parity-match the
    # engine bit for bit under deterministic SLO judgements
    slo_attainment: Dict = dataclasses.field(default_factory=dict)
    calibration: Dict = dataclasses.field(default_factory=dict)
    health_trace: List = dataclasses.field(default_factory=list)
    # failure-aware serving (serving.faults; engine mirror in
    # ServingEngine._result): requests dropped by the pre-admission
    # deadline / pressure shed pass, and whether the replica crashed
    # mid-serve.  Zero/False without a fault plan, so unfaulted results
    # stay field-for-field identical to pre-fault runs.
    timed_out: int = 0
    shed: int = 0
    crashed: bool = False
    #: KV blocks still reserved when the run ended — 0 under every
    #: fault schedule (crash eviction frees them), asserted by the
    #: no-leak property test
    kv_blocks_in_use: int = 0

    # ---- paper metrics ------------------------------------------------
    @property
    def response_times(self) -> np.ndarray:
        return np.array([t.response_time for t in self.tasks])

    @property
    def mean_response(self) -> float:
        return float(self.response_times.mean())

    @property
    def max_response(self) -> float:
        return float(self.response_times.max())

    @property
    def throughput_per_min(self) -> float:
        return 60.0 * len(self.tasks) / max(self.makespan, 1e-9)

    @property
    def miss_rate(self) -> float:
        return float(np.mean([t.missed for t in self.tasks]))

    def summary(self) -> Dict[str, float]:
        return {
            "mean_response_s": self.mean_response,
            "max_response_s": self.max_response,
            "p95_response_s": float(np.quantile(self.response_times, 0.95)),
            "throughput_per_min": self.throughput_per_min,
            "miss_rate": self.miss_rate,
            "n_tasks": len(self.tasks),
            "ttft_p50": self.ttft_p50,
            "ttft_p90": self.ttft_p90,
            "ttft_p99": self.ttft_p99,
            "itl_p50": self.itl_p50,
            "itl_p90": self.itl_p90,
            "itl_p99": self.itl_p99,
            "queue_wait_p50": self.queue_wait_p50,
            "queue_wait_p90": self.queue_wait_p90,
            "queue_wait_p99": self.queue_wait_p99,
        }


class Lane:
    def __init__(self, slowdown: float = 1.0):
        self.free_at = 0.0
        self.slowdown = slowdown
        self.busy_time = 0.0

    def run_batch(self, batch: List[SimTask], now: float,
                  persona: Persona, lane_name: str,
                  ttfts: Optional[Histogram] = None,
                  itls: Optional[Histogram] = None,
                  qwaits: Optional[Histogram] = None,
                  obs=None) -> float:
        start = max(now, self.free_at)
        dur = persona.batch_latency(
            [t.true_out_len for t in batch]) * self.slowdown
        finish = start + dur
        # linear streaming model for the tail metrics: the batch decodes
        # max(out_len) steps over ``dur``, so token j of every member is
        # emitted at a linear fraction of the horizon (uniform ITL)
        horizon = max(max((t.true_out_len for t in batch), default=1), 1)
        if obs is not None:
            # the engine's _run_batch emits the identical sequence
            # (events carry no step — bulk batches run outside the
            # iteration loop)
            obs.inc("prefill.dispatches")
            obs.span("bulk_batch", start, dur, lane=lane_name,
                     size=len(batch))
        for t in batch:
            t.start, t.finish, t.lane = start, finish, lane_name
            if ttfts is not None:
                ttfts.record(start + dur / horizon - t.r)
            if itls is not None and t.true_out_len > 1:
                itls.record(dur / horizon, t.true_out_len - 1)
            if qwaits is not None:
                qwaits.record(start - t.r)
            if obs is not None:
                obs.slo_observe("queue_wait", _cls(t), start,
                                start - t.r)
                if t.true_out_len >= 1:
                    obs.event("first_token", start + dur / horizon,
                              _tid(t), lane=lane_name)
                    obs.slo_observe("ttft", _cls(t),
                                    start + dur / horizon,
                                    start + dur / horizon - t.r)
                    if t.true_out_len > 1:
                        obs.slo_observe("itl", _cls(t), finish,
                                        dur / horizon,
                                        n=t.true_out_len - 1)
                obs.event("complete", finish, _tid(t), lane=lane_name,
                          out_len=t.true_out_len)
                obs.inc("sched.completions")
                obs.complete_request(_cls(t), finish, u=t.u,
                                     out_len=t.true_out_len,
                                     latency_s=finish - t.r)
        self.free_at = finish
        self.busy_time += dur
        return finish


def _obs_result_fields(obs) -> Dict:
    """The SLO/calibration/health members of ``SimResult`` pulled off
    an ``Observability`` bundle ({} / [] with the features off) — the
    exact mirror of the corresponding ``ServingEngine._result`` keys."""
    return {
        "slo_attainment": (obs.slo.attainment()
                           if obs is not None and obs.slo is not None
                           else {}),
        "calibration": (obs.calibration.summary()
                        if obs is not None
                        and obs.calibration is not None else {}),
        "health_trace": (list(obs.health_trace)
                         if obs is not None else []),
    }


def simulate(tasks: Sequence[SimTask], policy: sched_lib.Policy, *,
             xi: float = 2.0, per_task_overhead_s: float = 0.0,
             obs=None) -> SimResult:
    """Run the full trace through the node under ``policy``.

    per_task_overhead_s models the scheduler's own latency (Table VII);
    it is added to the dispatch instant of every formed batch.

    ``obs`` — optional ``repro_torch.obs.Observability``: records the same
    lifecycle event stream / counters as ``ServingEngine`` in batch
    mode (enqueue / first_token / complete, ``sched.completions``,
    ``prefill.dispatches``).
    """
    persona = policy.persona
    pending = sorted(tasks, key=lambda t: t.r)
    n_total = len(pending)
    queue: List[SimTask] = []
    cpu_queue: List[SimTask] = []
    done: List[SimTask] = []
    gpu = Lane(1.0)
    cpu = Lane(persona.cpu_slowdown)
    now = 0.0
    overhead_total = 0.0
    ttft_h, itl_h, qw_h = Histogram(), Histogram(), Histogram()
    dispatches = 0                  # one prefill launch per run batch
    dispatch_trace: List[int] = []
    i = 0
    C = persona.batch_size

    def dispatch_ready(now: float) -> bool:
        if not queue:
            return False
        if len(queue) >= C:
            return True
        oldest = min(t.r for t in queue)
        if now - oldest >= xi:
            return True
        # nothing else will ever arrive -> flush
        return i >= n_total

    while len(done) < n_total:
        # admit arrivals up to `now`
        while i < n_total and pending[i].r <= now + 1e-12:
            if obs is not None:
                cls = _cls(pending[i])
                obs.event("enqueue", pending[i].r, _tid(pending[i]),
                          **({"cls": cls} if cls else {}))
            queue.append(pending[i])
            i += 1

        progressed = False
        if gpu.free_at <= now + 1e-12 and dispatch_ready(now):
            gpu_batch, off_batch, rest = policy.select(list(queue), now)
            queue = list(rest)
            cpu_queue.extend(off_batch)
            if gpu_batch:
                oh = per_task_overhead_s * len(gpu_batch)
                overhead_total += oh
                gpu.run_batch(gpu_batch, now + oh, persona, "gpu",
                              ttft_h, itl_h, qw_h, obs)
                done.extend(gpu_batch)
                dispatches += 1
                dispatch_trace.append(1)
                progressed = True
        if cpu.free_at <= now + 1e-12 and cpu_queue:
            batch, cpu_queue = cpu_queue[:C], cpu_queue[C:]
            cpu.run_batch(batch, now, persona, "cpu", ttft_h, itl_h,
                          qw_h, obs)
            done.extend(batch)
            dispatches += 1
            dispatch_trace.append(1)
            progressed = True

        if progressed:
            continue
        # advance the clock to the next *future* event
        candidates = []
        if i < n_total:
            candidates.append(pending[i].r)
        if queue:
            candidates.append(min(t.r for t in queue) + xi)
            candidates.append(gpu.free_at)
        if cpu_queue:
            candidates.append(cpu.free_at)
        future = [c for c in candidates if c > now + 1e-12]
        now = min(future) if future else now + xi

    makespan = max(t.finish for t in done) - min(t.r for t in done)
    return SimResult(tasks=done, makespan=makespan,
                     overhead_s=overhead_total,
                     ttft_p50=ttft_h.quantile(0.50),
                     ttft_p90=ttft_h.quantile(0.90),
                     ttft_p99=ttft_h.quantile(0.99),
                     itl_p50=itl_h.quantile(0.50),
                     itl_p90=itl_h.quantile(0.90),
                     itl_p99=itl_h.quantile(0.99),
                     queue_wait_p50=qw_h.quantile(0.50),
                     queue_wait_p90=qw_h.quantile(0.90),
                     queue_wait_p99=qw_h.quantile(0.99),
                     prefill_dispatches=dispatches,
                     prefill_dispatch_trace=dispatch_trace,
                     **_obs_result_fields(obs))


@dataclasses.dataclass
class PrefixState:
    """Prefix-cache state surviving across ``simulate_continuous``
    calls — the simulator mirror of
    ``ServingEngine(persist_prefix_cache=True)``, whose page pool,
    allocator and prefix index outlive a single ``serve()``.  Build one
    with ``make_prefix_state`` and pass it to successive calls; each
    call resets the per-run counters (``PrefixCache.reset_stats``)
    while the index and its block pins carry over."""

    alloc: BlockAllocator
    pc: PrefixCache


def make_prefix_state(kv_num_blocks: int,
                      kv_block_size: int) -> PrefixState:
    alloc = BlockAllocator(kv_num_blocks, kv_block_size)
    return PrefixState(alloc=alloc, pc=PrefixCache(alloc, kv_block_size))


class _ReplicaSim:
    """One continuous-batching replica: the engine step loop's state
    machine (slots, queues, KV reservations, chunk scheduler, clock)
    factored out of ``simulate_continuous`` so ``simulate_replicated``
    can advance R independent instances on a shared virtual clock.

    The three verbs mirror the driver loop's phases:

      * ``deliver(task)``      — an arrival reaches this replica's queue
        (the enqueue event fires here, stamped at the arrival time);
      * ``iterate()``          — one engine iteration: admissions (stall
        or chunked), a decode window, the CPU lane; returns whether any
        progress was made;
      * ``advance_idle(cands)``— nothing progressed: jump the clock to
        the next future candidate (caller adds the next arrival), else
        burn one xi batching window.

    ``simulate_continuous`` drives exactly one instance — bit-identical
    to the pre-factoring single loop; the replicated driver additionally
    reads ``load()`` (the router's view) and ``has_work()``.
    """

    def __init__(self, policy: sched_lib.Policy, *,
                 xi: float = 2.0,
                 per_task_overhead_s: float = 0.0,
                 num_slots: Optional[int] = None,
                 kv_block_size: Optional[int] = None,
                 kv_num_blocks: Optional[int] = None,
                 prompt_len: int = 0,
                 prefill: str = "stall",
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 prefix_cache: bool = False,
                 prompt_tokens=None,
                 decode_steps: int = 1,
                 prefix_state: Optional[PrefixState] = None,
                 faults=None,
                 obs=None) -> None:
        self.policy = policy
        self.persona = policy.persona
        self.xi = xi
        self.per_task_overhead_s = per_task_overhead_s
        self.obs = obs
        self.C = num_slots if num_slots is not None \
            else self.persona.batch_size
        self.kv_block_size = kv_block_size
        self.kv_num_blocks = kv_num_blocks
        self.kv_model = kv_block_size is not None \
            and kv_num_blocks is not None
        self.prompt_len = prompt_len
        self.prompt_tokens = prompt_tokens
        if prefill not in ("stall", "chunked"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        self.chunked = prefill == "chunked"
        self.sched: Optional[ChunkScheduler] = None
        if self.chunked:
            if prompt_len <= 0:
                raise ValueError('prefill="chunked" needs prompt_len > 0')
            if chunk_size is None or token_budget is None:
                raise ValueError('prefill="chunked" needs chunk_size and '
                                 'token_budget')
            self.sched = ChunkScheduler(
                chunk_size, token_budget,
                metrics=obs.metrics if obs is not None else None)
        if decode_steps < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {decode_steps}")
        self.decode_steps = decode_steps
        # failure-aware serving (serving.faults.ReplicaFaults): the
        # pre-admission shed pass + straggler slowdowns run inside
        # iterate(); crashes are driven from outside (the replicated
        # driver / fault coordinator).  Restricted to the stall prefill
        # path — the chunked packer has no engine-parity shed point.
        self.faults = faults
        if faults is not None and self.chunked:
            raise ValueError('faults require prefill="stall"')
        self.timed_out: List[SimTask] = []   # deadline-shed terminals
        self.shed_tasks: List[SimTask] = []  # pressure-shed terminals
        self.crashed = False
        self.pc: Optional[PrefixCache] = None
        self.alloc: Optional[BlockAllocator] = None
        if prefix_state is not None and not prefix_cache:
            raise ValueError("prefix_state requires prefix_cache=True")
        if prefix_cache:
            if not self.kv_model:
                raise ValueError('prefix_cache=True needs kv_block_size '
                                 'and kv_num_blocks (the block-budget '
                                 'model)')
            if prompt_len <= 0:
                raise ValueError('prefix_cache=True needs prompt_len > 0')
            if prompt_tokens is None:
                raise ValueError('prefix_cache=True needs a '
                                 'prompt_tokens callable (task -> '
                                 'padded token bucket)')
            if prefix_state is not None:
                self.alloc, self.pc = prefix_state.alloc, prefix_state.pc
                self.pc.reset_stats()
            else:
                self.alloc = BlockAllocator(kv_num_blocks, kv_block_size)
                self.pc = PrefixCache(self.alloc, kv_block_size)
            # same registry hookup the engine's _paged_setup makes, so
            # the "prefix.*" counters stream into the shared parity view
            self.pc.metrics = obs.metrics if obs is not None else None
        C = self.C
        self.slots: List[Optional[SimTask]] = [None] * C
        self.produced = [0] * C
        self.reserved = [0] * C
        self.slot_toks: Dict[int, tuple] = {}  # chunked+prefix: bucket
        self.queue: List[SimTask] = []
        self.cpu_queue: List[SimTask] = []
        self.done: List[SimTask] = []
        self.cpu = Lane(self.persona.cpu_slowdown)
        self.now = 0.0
        self.overhead_total = 0.0
        self.rejected_ids: set = set()  # distinct tasks deferred for mem
        self.kv_util: List[float] = []
        self.budget_trace: List = []
        self.dispatches = 0             # prefill launches (engine mirror)
        self.dispatch_trace: List[int] = []
        self.exec_keys: set = set()     # fused-executable key novelty
        self.exec_hits = 0
        self.exec_misses = 0
        self.dispatches_dec = 0         # decode windows (engine mirror)
        self.steps_dec = 0              # decode steps across all windows
        self.dec_trace: List[int] = []  # steps per window
        self.ttft_h = Histogram()
        self.itl_h = Histogram()
        self.qw_h = Histogram()
        self.last_tok = [0.0] * C       # last token emission per slot
        self.peak_conc = 0
        self.delivered = 0
        self.step = 0                   # decode steps executed so far —
        # the engine's iteration coordinate; stamped on every event so
        # engine and sim streams line up position for position

    # ------------------------------------------------------------------
    def check_fits(self, tasks: Sequence[SimTask]) -> None:
        """The upfront deadlock guard: the largest task's worst-case
        reservation must fit an EMPTY pool or admission can never
        succeed (same check for every replica — pools are equal)."""
        if not self.kv_model:
            return
        worst = max((blocks_for_tokens(
            self.prompt_len + max(1, t.true_out_len) - 1,
            self.kv_block_size) for t in tasks), default=0)
        if worst > self.kv_num_blocks:
            raise ValueError(
                f"kv_num_blocks={self.kv_num_blocks} cannot hold the "
                f"largest task ({worst} blocks) — admission would "
                f"deadlock")

    def terminal_count(self) -> int:
        """Requests that reached ANY terminal outcome here: completed,
        deadline-timed-out or shed.  Crash survivors are subtracted
        from ``delivered`` instead — they terminate elsewhere."""
        return (len(self.done) + len(self.timed_out)
                + len(self.shed_tasks))

    def has_work(self) -> bool:
        """Delivered-but-unfinished work exists on this replica."""
        return self.delivered > self.terminal_count()

    def load(self) -> Dict:
        """The router's live view of this replica: placed-but-unfinished
        work (queue + CPU lane + chunked prefill jobs + active slots),
        occupied decode slots, and KV-pool headroom.  Keys match the
        ``repro_torch.serving.router.ReplicaView`` fields; the engine
        front-end builds the same view from its placement bookkeeping,
        so routing decisions parity-match bit for bit on all-at-t0
        traces (where every placement precedes any engine work)."""
        active = [t for t in self.slots if t is not None]
        inflight = list(active)
        if self.chunked:
            inflight += [j.task for j in self.sched.jobs]
        tasks = list(self.queue) + list(self.cpu_queue) + inflight
        return {
            "queued": len(tasks),
            "active": len(active),
            "free_blocks": (self.kv_num_blocks - sum(self.reserved)
                            if self.kv_model else 0),
            "num_blocks": self.kv_num_blocks if self.kv_model else 0,
            "u_load": float(sum(t.u for t in tasks)),
        }

    def deliver(self, task: SimTask) -> None:
        """An arrival reaches this replica's queue (enqueue event at the
        arrival timestamp, as the engine's serve prologue stamps it)."""
        if self.obs is not None:
            cls = _cls(task)
            self.obs.event("enqueue", task.r, _tid(task), self.step,
                           **({"cls": cls} if cls else {}))
        self.queue.append(task)
        self.delivered += 1

    def advance_idle(self, candidates: Sequence[float] = ()) -> None:
        """Nothing progressed: jump to the next future event (callers
        append the next arrival time), else burn one xi window."""
        cands = list(candidates)
        if self.cpu_queue:
            cands.append(self.cpu.free_at)
        future = [c for c in cands if c > self.now + 1e-12]
        self.now = min(future) if future else self.now + self.xi

    def crash(self) -> List[SimTask]:
        """Replica death (serving.faults.CrashFault): every active slot
        is evicted in slot order (its KV blocks freed — the engine does
        the same, so allocator free-list state stays bit-identical),
        and every unfinished request — active, queued, CPU-lane — is
        returned as a survivor for the fault coordinator to
        re-dispatch; ``delivered`` drops by the survivor count so the
        replica reads as drained.  Progress (``produced`` tokens) is
        lost: failover restarts a request from scratch on its target,
        the standard no-KV-migration semantics."""
        obs = self.obs
        survivors: List[SimTask] = []
        for s in range(self.C):
            t = self.slots[s]
            if t is None:
                continue
            if obs is not None:
                obs.event("evict", self.now, _tid(t), self.step, slot=s)
            if self.pc is not None:
                self.alloc.free_sequence(id(t))
            self.slots[s] = None
            self.reserved[s] = 0
            self.produced[s] = 0
            survivors.append(t)
        survivors += list(self.queue) + list(self.cpu_queue)
        self.queue = []
        self.cpu_queue = []
        self.delivered -= len(survivors)
        self.crashed = True
        if obs is not None:
            obs.event("replica_down", self.now, None, self.step,
                      reason="crash", survivors=len(survivors))
            obs.inc("faults.replica_down")
        return survivors

    # ------------------------------------------------------------------
    def _admit_one(self, running):
        """Shared admission prologue: one ``policy.admit`` consultation
        plus the block-reservation gate, overhead / setup charges and
        the CPU-lane fork — identical for the stall and chunked
        branches (the engine mirrors it bit for bit).  Returns
        ("stop", None, 0) to end the admission loop, ("cpu", None, 0)
        when the task was offloaded, or ("gpu", task, need)."""
        obs = self.obs
        prev_queue = list(self.queue)
        task, lane, rest = self.policy.admit(list(self.queue), self.now,
                                             running)
        if task is None:
            return "stop", None, 0
        self.queue = list(rest)
        need = 0
        if self.kv_model and lane != "cpu":
            need = blocks_for_tokens(
                self.prompt_len + max(1, task.true_out_len) - 1,
                self.kv_block_size)
            if need > self.kv_num_blocks - sum(self.reserved):
                self.queue = prev_queue        # leave it queued
                self.rejected_ids.add(id(task))
                if obs is not None:
                    obs.event("reject", self.now, _tid(task), self.step,
                              kv_blocks=need)
                    obs.inc("sched.rejections")
                return "stop", None, 0
        self.overhead_total += self.per_task_overhead_s
        self.now += self.per_task_overhead_s
        if lane == "cpu":
            if obs is not None:
                obs.event("offload", self.now, _tid(task), self.step)
                obs.inc("sched.offloads")
            self.cpu_queue.append(task)
            return "cpu", None, 0
        if not running:
            self.now += self.persona.setup_time  # restart from idle
        return "gpu", task, need

    # ------------------------------------------------------------------
    def iterate(self) -> bool:
        """One engine iteration (admissions, decode window, CPU lane);
        returns whether any progress was made."""
        obs, persona, C = self.obs, self.persona, self.C
        pc, alloc = self.pc, self.alloc
        slots, produced = self.slots, self.produced
        reserved, slot_toks = self.reserved, self.slot_toks
        last_tok, done = self.last_tok, self.done
        kv_util = self.kv_util
        ttft_h, itl_h, qw_h = self.ttft_h, self.itl_h, self.qw_h
        prompt_len, decode_steps = self.prompt_len, self.decode_steps
        kv_model, chunked = self.kv_model, self.chunked

        progressed = False
        if chunked:
            sched = self.sched
            # admissions enqueue a chunk job; the slot is held by the
            # job (not decoding yet) until its last chunk completes
            in_prefill = set(sched.slots_in_prefill())
            free = [s for s in range(C)
                    if slots[s] is None and s not in in_prefill]
            while self.queue and free:
                running = ([t for t in slots if t is not None]
                           + [j.task for j in sorted(sched.jobs,
                                                     key=lambda j: j.seq)])
                status, task, need = self._admit_one(running)
                if status == "stop":
                    break
                if status == "cpu":
                    continue
                s = free.pop(0)
                if kv_model:
                    reserved[s] = need
                qw_h.record(self.now - task.r)
                if obs is not None:
                    obs.event("admit", self.now, _tid(task), self.step,
                              slot=s, u=task.u, kv_blocks=need)
                    obs.inc("sched.admissions")
                    obs.observe("queue_wait_s", self.now - task.r)
                    obs.slo_observe("queue_wait", _cls(task), self.now,
                                    self.now - task.r)
                total = prompt_len
                if pc is not None:
                    # matched prefix blocks shared at admission (same
                    # call the engine makes); the chunk job covers only
                    # the uncached suffix
                    toks = tuple(self.prompt_tokens(task))
                    adm = pc.admit(id(task), toks)
                    if obs is not None and adm.matched_blocks:
                        obs.event("prefix_hit", self.now, _tid(task),
                                  self.step, cached_tokens=adm.start,
                                  matched_blocks=adm.matched_blocks,
                                  cow=len(adm.cow))
                    slot_toks[s] = toks
                    total = prompt_len - adm.start
                sched.add(task, s, total,
                          self.policy.assign_priority(task))
                progressed = True

            # chunk phase: pack the budget, decode tokens first.  The
            # engine executes the whole plan as ONE fused ragged launch
            # (pack_plans -> ChunkBatch); mirror its dispatch count and
            # executable-cache shape-key novelty from the same call —
            # the latency model still charges per-chunk token cost.
            active0 = [s for s in range(C) if slots[s] is not None]
            plans = sched.schedule(len(active0)) if sched.has_jobs else []
            chunk_batch = pack_plans(plans)
            if chunk_batch is not None:
                self.dispatches += 1
                hit = chunk_batch.shape_key in self.exec_keys
                if hit:
                    self.exec_hits += 1
                else:
                    self.exec_keys.add(chunk_batch.shape_key)
                    self.exec_misses += 1
                if obs is not None:
                    # mirror of the engine's fused-launch emission: one
                    # exec_cache probe then one prefill_chunk per MERGED
                    # chunk (the ragged batch the engine launches), all
                    # before any finishing first_token — identical
                    # stream order, from the same pack_plans result
                    obs.event("exec_cache", self.now, None, self.step,
                              hit=hit,
                              shape_key=str(chunk_batch.shape_key))
                    obs.inc("exec_cache.hits" if hit
                            else "exec_cache.misses")
                    obs.inc("prefill.dispatches")
                    pf_cost = (persona.item_time
                               * chunk_batch.total_tokens / prompt_len)
                    obs.span("prefill.ragged", self.now, pf_cost,
                             chunks=len(chunk_batch.chunks),
                             tokens=chunk_batch.total_tokens)
                    for ch in chunk_batch.chunks:
                        obs.event("prefill_chunk", self.now,
                                  _tid(ch.job.task), self.step,
                                  slot=ch.slot, start=ch.start,
                                  length=ch.length, finishes=ch.finishes,
                                  shape_key=str(chunk_batch.shape_key))
            for plan in plans:
                self.now += persona.item_time * plan.length / prompt_len
                if plan.finishes:
                    task, s = plan.job.task, plan.job.slot
                    if pc is not None:
                        pc.commit(id(task), slot_toks.pop(s))
                    task.start, task.lane = self.now, "gpu"
                    ttft_h.record(self.now - task.r)
                    if obs is not None:
                        obs.event("first_token", self.now, _tid(task),
                                  self.step, slot=s)
                        obs.slo_observe("ttft", _cls(task), self.now,
                                        self.now - task.r)
                    if task.true_out_len <= 1:  # first token already EOS
                        task.finish = self.now
                        done.append(task)
                        reserved[s] = 0
                        if pc is not None:
                            alloc.free_sequence(id(task))
                        if obs is not None:
                            obs.event("complete", self.now, _tid(task),
                                      self.step, lane="gpu", out_len=1)
                            obs.event("evict", self.now, _tid(task),
                                      self.step, slot=s)
                            obs.inc("sched.completions")
                            obs.complete_request(
                                _cls(task), self.now, u=task.u,
                                out_len=1,
                                latency_s=self.now - task.r)
                    else:
                        slots[s] = task         # joins THIS step's decode
                        produced[s] = 1         # prefill emits token 1
                        last_tok[s] = self.now
            if plans:
                progressed = True
            if plans or any(t is not None for t in slots):
                self.budget_trace.append(
                    (len(active0), sum(p.length for p in plans)))
                self.dispatch_trace.append(1 if plans else 0)
                # aligned with budget_trace, as in the engine: steps
                # launched this iteration (0 = prefill-only iteration)
                self.dec_trace.append(decode_steps
                                      if any(t is not None
                                             for t in slots)
                                      else 0)
        else:
            if self.faults is not None and self.queue:
                # failure-aware pre-admission pass (serving.faults):
                # doomed-request timeouts + pressure shedding — the
                # same shed_pass call the engine's stall loop makes at
                # the same point, so events/counters parity-match
                from ..serving.faults import shed_pass
                kept, timed, dropped = shed_pass(
                    self.queue, now=self.now, step=self.step,
                    rf=self.faults,
                    slo=obs.slo if obs is not None else None, obs=obs)
                if timed or dropped:
                    self.queue = kept
                    self.timed_out += timed
                    self.shed_tasks += dropped
                    progressed = True
            # admissions into freed slots (uncertainty-aware, stalling
            # the loop for one amortized prefill per admission — and
            # one prefill LAUNCH per admission, the burst the fused
            # chunked path collapses to one per iteration)
            iter_launches = 0
            while self.queue and None in slots:
                running = [t for t in slots if t is not None]
                status, task, need = self._admit_one(running)
                if status == "stop":
                    break
                if status == "cpu":
                    continue
                self.dispatches += 1
                iter_launches += 1
                # slot chosen BEFORE prefill (as the engine does): the
                # admit event carries it even for an immediate finish
                s = slots.index(None)
                tid = _tid(task)
                qw_h.record(self.now - task.r)
                if obs is not None:
                    obs.event("admit", self.now, tid, self.step, slot=s,
                              u=task.u, kv_blocks=need)
                    obs.inc("sched.admissions")
                    obs.observe("queue_wait_s", self.now - task.r)
                    obs.slo_observe("queue_wait", _cls(task), self.now,
                                    self.now - task.r)
                pf_t0 = self.now
                pf_start, pf_key, pf_hit = 0, "admit", False
                if pc is not None:
                    # prefill cost scales with the uncached suffix —
                    # the same admit/commit calls the engine's stall
                    # path makes, so counters match bit for bit
                    toks = tuple(self.prompt_tokens(task))
                    adm = pc.admit(id(task), toks)
                    if obs is not None and adm.matched_blocks:
                        obs.event("prefix_hit", self.now, tid, self.step,
                                  cached_tokens=adm.start,
                                  matched_blocks=adm.matched_blocks,
                                  cow=len(adm.cow))
                    if adm.start > 0:
                        # the engine routes the uncached suffix through
                        # the fused ragged executable as a single-chunk
                        # launch; mirror its shape-key novelty
                        key = suffix_shape_key(prompt_len - adm.start)
                        pf_hit = key in self.exec_keys
                        if pf_hit:
                            self.exec_hits += 1
                        else:
                            self.exec_keys.add(key)
                            self.exec_misses += 1
                        pf_start, pf_key = adm.start, str(key)
                    self.now += (persona.item_time
                                 * (prompt_len - adm.start) / prompt_len)
                    pc.commit(id(task), toks)
                else:
                    self.now += persona.item_time  # per-member bandwidth
                task.start, task.lane = self.now, "gpu"
                ttft_h.record(self.now - task.r)
                if obs is not None:
                    # same post-launch emission the engine's stall path
                    # makes (exec_cache only on the prefix-suffix path)
                    if pf_key != "admit":
                        obs.event("exec_cache", self.now, tid, self.step,
                                  hit=pf_hit, shape_key=pf_key)
                        obs.inc("exec_cache.hits" if pf_hit
                                else "exec_cache.misses")
                    obs.inc("prefill.dispatches")
                    obs.span("prefill.admit", pf_t0, self.now - pf_t0,
                             task=tid, slot=s)
                    obs.event("prefill_chunk", self.now, tid, self.step,
                              slot=s, start=pf_start,
                              length=prompt_len - pf_start,
                              finishes=True, shape_key=pf_key)
                    obs.event("first_token", self.now, tid, self.step,
                              slot=s)
                    obs.slo_observe("ttft", _cls(task), self.now,
                                    self.now - task.r)
                if task.true_out_len <= 1:     # first token already EOS
                    task.finish = self.now
                    done.append(task)
                    if pc is not None:
                        alloc.free_sequence(id(task))
                    if obs is not None:
                        obs.event("complete", self.now, tid, self.step,
                                  lane="gpu", out_len=1)
                        obs.event("evict", self.now, tid, self.step,
                                  slot=s)
                        obs.inc("sched.completions")
                        obs.complete_request(
                            _cls(task), self.now, u=task.u, out_len=1,
                            latency_s=self.now - task.r)
                else:
                    slots[s] = task
                    produced[s] = 1            # prefill emits token 1
                    last_tok[s] = self.now
                    if kv_model:
                        reserved[s] = need
                progressed = True
            if iter_launches:
                self.dispatch_trace.append(iter_launches)

        if any(t is not None for t in slots):
            active = [s for s in range(C) if slots[s] is not None]
            self.peak_conc = max(self.peak_conc, len(active))
            nsteps = decode_steps
            if kv_model and pc is not None:
                # real-allocator model (prefix mode): mirror the
                # engine's pre-window extension host-side (every useful
                # write of the next nsteps launches, clamped at the
                # reservation — kvcache.window_target_tokens), then
                # sample the allocator directly — shared prefix blocks
                # and cached-but-unreferenced blocks count once,
                # exactly as in the engine's utilization samples
                for s in active:
                    key = id(slots[s])
                    target = blocks_for_tokens(window_target_tokens(
                        prompt_len, produced[s],
                        max(1, slots[s].true_out_len), nsteps),
                        self.kv_block_size)
                    while target > len(alloc.table(key)):
                        alloc.allocate(key)
                kv_util.append(alloc.utilization())
            elif kv_model:
                # lazy-allocation model: the window writes logical
                # positions up to the window target (clamped at the
                # sequence's reservation), so each slot holds
                # blocks_for(window_target) physical blocks; slots
                # mid-chunked-prefill hold their whole prompt's blocks
                # (allocated at admission, as in the engine)
                held = sum(blocks_for_tokens(window_target_tokens(
                    prompt_len, produced[s],
                    max(1, slots[s].true_out_len), nsteps),
                    self.kv_block_size)
                    for s in active)
                if chunked:
                    held += (len(self.sched.slots_in_prefill())
                             * blocks_for_tokens(prompt_len,
                                                 self.kv_block_size))
                kv_util.append(held / self.kv_num_blocks)
            else:
                kv_util.append(len(active) / C)
            self.dispatches_dec += 1
            self.steps_dec += nsteps
            self.step += nsteps
            if not chunked:
                # stall mode: one trace entry per executed window (the
                # chunked entry was appended with budget_trace above)
                self.dec_trace.append(nsteps)
            if obs is not None:
                # mirror of the engine's per-window emission (the
                # engine stamps the step coordinate AFTER advancing it,
                # as here; event timestamps are model time)
                obs.inc("decode.dispatches")
                obs.inc("decode.steps", nsteps)
                obs.gauge("kv.util", kv_util[-1])
                obs.counter_sample("kv.util", self.now, kv_util[-1])
                obs.span("decode.window", self.now,
                         nsteps * persona.eta,
                         steps=nsteps, active=len(active))
                obs.event("decode_window", self.now, None, self.step,
                          steps=nsteps, active=len(active),
                          dur=nsteps * persona.eta)
            # N-step window, consumed step-major; a sequence finishing
            # at window step j stops producing but keeps its slot and
            # blocks until window end (eviction in arrears — the
            # engine's eviction-lag invariant)
            finished: List[int] = []
            base_step = self.step - nsteps
            for j in range(nsteps):
                # one decode step, all slots; a straggler fault
                # (serving.faults.SlowFault) stretches the step's model
                # time — wall fields are parity-stripped, so only the
                # virtual clock bends
                eta = persona.eta
                if self.faults is not None:
                    eta *= self.faults.slow_factor(base_step + j)
                self.now += eta
                for s in active:
                    if s in finished:
                        continue
                    produced[s] += 1
                    gap = self.now - last_tok[s]
                    itl_h.record(gap)
                    last_tok[s] = self.now
                    if obs is not None:
                        obs.event("token", self.now, _tid(slots[s]),
                                  self.step, slot=s, idx=produced[s])
                        obs.slo_observe("itl", _cls(slots[s]), self.now,
                                        gap)
                    if produced[s] >= slots[s].true_out_len:
                        slots[s].finish = self.now
                        done.append(slots[s])
                        finished.append(s)
                        if obs is not None:
                            obs.event("complete", self.now,
                                      _tid(slots[s]), self.step,
                                      lane="gpu", out_len=produced[s])
                            obs.inc("sched.completions")
                            obs.complete_request(
                                _cls(slots[s]), self.now, u=slots[s].u,
                                out_len=produced[s],
                                latency_s=self.now - slots[s].r)
                            # eviction lag: window steps this slot's
                            # blocks stay held past its logical end
                            obs.observe("decode.eviction_lag_steps",
                                        nsteps - 1 - j)
            # window-end frees in slot order (matches the engine, so
            # allocator free-list state stays bit-identical)
            for s in active:
                if s not in finished:
                    continue
                if obs is not None:
                    obs.event("evict", self.now, _tid(slots[s]),
                              self.step, slot=s)
                if pc is not None:
                    alloc.free_sequence(id(slots[s]))
                slots[s] = None
                reserved[s] = 0
            if obs is not None:
                # same post-window snapshot point as the engine's serve
                # loops: after window bookkeeping and eviction, keyed
                # off the shared ``step`` coordinate
                obs.maybe_snapshot(
                    self.now, self.step, queue_depth=len(self.queue),
                    active=sum(t is not None for t in slots),
                    kv_util=kv_util[-1])
            progressed = True

        if self.cpu.free_at <= self.now + 1e-12 and self.cpu_queue:
            batch = self.cpu_queue[:C]
            self.cpu_queue = self.cpu_queue[C:]
            self.cpu.run_batch(batch, self.now, persona, "cpu", ttft_h,
                               itl_h, qw_h, obs)
            done.extend(batch)
            # bulk-lane launches count in the total only: the trace is
            # the decode loop's per-iteration launch profile (engine
            # mirror — _run_batch does the same in continuous modes)
            self.dispatches += 1
            progressed = True

        return progressed

    # ------------------------------------------------------------------
    def result(self) -> SimResult:
        """The completion-ordered ``SimResult`` epilogue (a replica that
        received no work reports an empty, zeroed result)."""
        done = self.done
        makespan = (max(t.finish for t in done)
                    - min(t.r for t in done)) if done else 0.0
        util = np.array(self.kv_util) if self.kv_util else np.zeros(1)
        pstats = self.pc.stats() if self.pc is not None else {}
        return SimResult(tasks=done, makespan=makespan,
                         overhead_s=self.overhead_total,
                         kv_rejected=len(self.rejected_ids),
                         kv_util_peak=float(util.max()),
                         kv_util_mean=float(util.mean()),
                         peak_concurrency=self.peak_conc,
                         ttft_p50=self.ttft_h.quantile(0.50),
                         ttft_p90=self.ttft_h.quantile(0.90),
                         ttft_p99=self.ttft_h.quantile(0.99),
                         itl_p50=self.itl_h.quantile(0.50),
                         itl_p90=self.itl_h.quantile(0.90),
                         itl_p99=self.itl_h.quantile(0.99),
                         queue_wait_p50=self.qw_h.quantile(0.50),
                         queue_wait_p90=self.qw_h.quantile(0.90),
                         queue_wait_p99=self.qw_h.quantile(0.99),
                         budget_trace=self.budget_trace,
                         prefill_dispatches=self.dispatches,
                         prefill_dispatch_trace=self.dispatch_trace,
                         exec_cache_hits=self.exec_hits,
                         exec_cache_misses=self.exec_misses,
                         decode_dispatches=self.dispatches_dec,
                         decode_steps_executed=self.steps_dec,
                         decode_dispatch_trace=self.dec_trace,
                         prefix_hit_rate=pstats.get(
                             "prefix_hit_rate", 0.0),
                         cached_tokens_reused=pstats.get(
                             "cached_tokens_reused", 0),
                         cow_copies=pstats.get("cow_copies", 0),
                         prefix_evictions=pstats.get(
                             "prefix_evictions", 0),
                         timed_out=len(self.timed_out),
                         shed=len(self.shed_tasks),
                         crashed=self.crashed,
                         kv_blocks_in_use=(sum(self.reserved)
                                           if self.kv_model else 0),
                         **_obs_result_fields(self.obs))


def simulate_continuous(tasks: Sequence[SimTask],
                        policy: sched_lib.Policy, *,
                        xi: float = 2.0,
                        per_task_overhead_s: float = 0.0,
                        num_slots: Optional[int] = None,
                        kv_block_size: Optional[int] = None,
                        kv_num_blocks: Optional[int] = None,
                        prompt_len: int = 0,
                        prefill: str = "stall",
                        chunk_size: Optional[int] = None,
                        token_budget: Optional[int] = None,
                        prefix_cache: bool = False,
                        prompt_tokens=None,
                        decode_steps: int = 1,
                        prefix_state: Optional[PrefixState] = None,
                        faults=None,
                        obs=None) -> SimResult:
    """Iteration-level (continuous) batching over C decode slots.

    Mirrors the real engine's step loop exactly (serving/engine.py
    ``_serve_continuous``): each iteration admits queued tasks into free
    slots in ascending slot order (policy.admit per slot), then advances
    every active slot by one decode step; slots whose sequence finished
    are evicted the same step.  SimResult.tasks is completion-ordered —
    the engine-vs-sim parity tests compare exactly that order.

    Block-budget admission (the paged-KV memory model): when
    ``kv_block_size``/``kv_num_blocks`` are given, admitting a task
    additionally requires its worst-case block reservation
    ``blocks_for_tokens(prompt_len + true_out_len - 1, block_size)`` to
    fit in ``kv_num_blocks`` minus the reservations of every running
    slot — the same gate the paged engine applies (it uses the request
    cap where the sim uses true_out_len; the parity traces make them
    equal).  A non-fitting front-runner is left queued; ``kv_rejected``
    counts DISTINCT tasks deferred at least once (a blocked task is
    retried every step); allocation is modeled lazily (blocks cover written
    positions) for the utilization metrics.  ``num_slots`` decouples
    decode width from the persona batch size, as the paged engine does.

    Chunked prefill (``prefill="chunked"`` — the cost model of the
    engine's chunked mode): admission enqueues the padded prompt into a
    ``repro_torch.prefill.ChunkScheduler`` — the SAME packer the real engine
    drives — instead of materializing the first token at admission.
    Each iteration packs the token budget with decode tokens first plus
    prefill chunks in the policy's priority order; a chunk of T tokens
    costs ``item_time * T / prompt_len`` (a whole prompt still totals
    the stall model's amortized ``item_time``), and the first token
    materializes when the last chunk completes.  ``budget_trace``
    records the engine-identical per-iteration (decode_tokens,
    prefill_tokens) pairs the parity tests compare entry for entry.

    Prefix caching (``prefix_cache=True`` — the cache model of the
    engine's ``prefix_cache=True``): requires the block-budget model
    plus ``prompt_tokens``, a callable mapping a task to its PADDED
    prompt token bucket (the parity tests pass the engine's exact
    ``_tokenize_padded`` recipe).  The simulator then drives a real
    host-side ``BlockAllocator`` + ``PrefixCache`` through the same
    admit/commit/extend/free call sequence as the engine, so hit
    counts, CoW copies, LRU evictions and the per-step utilization
    trace agree bit-for-bit.  Prefill cost scales with the UNCACHED
    suffix: stall admission charges ``item_time * suffix / prompt_len``
    and chunk jobs cover only the suffix — cache hits shorten TTFT.

    Multi-step decode windows (``decode_steps=N`` — the cost model of
    the engine's async host pipeline): each decode iteration advances
    every active slot by N steps in one modeled launch, block tables
    are pre-extended to ``kvcache.window_target_tokens`` (clamped at
    the admission reservation, so rejection decisions are independent
    of N), tokens are consumed step-major, and EVICTION IS IN ARREARS:
    a sequence finishing at window step j frees its blocks — and its
    slot — only at window end, exactly as the engine does.  Admissions
    therefore happen only at window boundaries, one utilization sample
    is taken per window, and ``decode_dispatch_trace`` records steps
    per window; ``decode_steps=1`` reduces bit-for-bit to the
    synchronous per-step model.  ``prefix_state``
    (``make_prefix_state``) carries the allocator + prefix index across
    calls — the mirror of ``persist_prefix_cache=True``.

    Observability (``obs`` — a ``repro_torch.obs.Observability``): the
    simulator emits the SAME request-lifecycle event stream as the
    engine's serve loops, from the same decision points, with the same
    non-wall fields (slot, step, uncertainty score, kv blocks, dispatch
    shape key, ...) — ``TraceRecorder.parity_events()`` of an engine
    run and a sim run of the same trace compare EQUAL, and every
    counter both sides emit (``MetricsRegistry.counters()``) matches
    bit-for-bit (tests/test_obs.py::test_engine_vs_sim_event_parity).
    Only wall-clock fields (event timestamps, span durations) differ:
    the sim stamps model time, the engine stamps its virtual clock.

    Failure-aware serving (``faults`` — a
    ``repro_torch.serving.faults.ReplicaFaults``): per-request deadlines and
    uncertainty-aware load shedding run as a pre-admission pass, and
    straggler slowdowns stretch decode-step model time — mirroring
    ``ServingEngine(faults=...)`` call for call.  Crash faults need the
    replicated driver (failover has nowhere to go at R=1) and raise
    here.  Timed-out/shed requests are terminal: counted in
    ``SimResult.timed_out``/``shed``, never in ``tasks``.
    """
    pending = sorted(tasks, key=lambda t: t.r)
    n_total = len(pending)
    if faults is not None and faults.crash_at_step is not None:
        raise ValueError("crash faults need the replicated driver "
                         "(simulate_replicated / ReplicatedEngine) — "
                         "failover has nowhere to go at R=1")
    rep = _ReplicaSim(policy, xi=xi,
                      per_task_overhead_s=per_task_overhead_s,
                      num_slots=num_slots, kv_block_size=kv_block_size,
                      kv_num_blocks=kv_num_blocks, prompt_len=prompt_len,
                      prefill=prefill, chunk_size=chunk_size,
                      token_budget=token_budget,
                      prefix_cache=prefix_cache,
                      prompt_tokens=prompt_tokens,
                      decode_steps=decode_steps,
                      prefix_state=prefix_state, faults=faults, obs=obs)
    rep.check_fits(pending)
    i = 0
    while rep.terminal_count() < n_total:
        while i < n_total and pending[i].r <= rep.now + 1e-12:
            rep.deliver(pending[i])
            i += 1
        if rep.iterate():
            continue
        rep.advance_idle([pending[i].r] if i < n_total else [])
    return rep.result()


@dataclasses.dataclass
class ReplicatedSimResult:
    """R per-replica ``SimResult``s plus the router's placement record
    and pool-level latency percentiles (merged from every replica's
    streaming histograms — the same substrate the per-replica
    percentiles use, so pooled == merged, not averaged)."""

    replicas: List[SimResult]
    placements: List[int]            # arrival-order replica choice
    router_policy: str
    n_tasks: int
    makespan: float
    ttft_p50: float = 0.0
    ttft_p90: float = 0.0
    ttft_p99: float = 0.0
    itl_p50: float = 0.0
    itl_p90: float = 0.0
    itl_p99: float = 0.0
    queue_wait_p50: float = 0.0
    queue_wait_p90: float = 0.0
    queue_wait_p99: float = 0.0
    # failure-aware serving (serving.faults; all zero/empty without a
    # fault plan — unfaulted results stay field-for-field identical):
    # pool-level terminal + recovery accounting.  A dead-lettered
    # arrival records placement -1.
    timed_out: int = 0
    shed: int = 0
    retries: int = 0
    failovers: int = 0
    dead_lettered: int = 0
    failover_placements: List = dataclasses.field(default_factory=list)

    @property
    def tasks(self) -> List[SimTask]:
        """All completed tasks, ordered by finish time (per-replica
        completion order is in ``replicas[r].tasks``)."""
        out = [t for r in self.replicas for t in r.tasks]
        out.sort(key=lambda t: t.finish)
        return out

    def placement_counts(self) -> List[int]:
        return [self.placements.count(r)
                for r in range(len(self.replicas))]

    def summary(self) -> Dict:
        return {
            "n_tasks": self.n_tasks,
            "replicas": len(self.replicas),
            "router_policy": self.router_policy,
            "makespan_s": self.makespan,
            "placement_counts": self.placement_counts(),
            "kv_rejected": sum(r.kv_rejected for r in self.replicas),
            "ttft_p50": self.ttft_p50,
            "ttft_p90": self.ttft_p90,
            "ttft_p99": self.ttft_p99,
            "itl_p50": self.itl_p50,
            "itl_p90": self.itl_p90,
            "itl_p99": self.itl_p99,
            "queue_wait_p50": self.queue_wait_p50,
            "queue_wait_p90": self.queue_wait_p90,
            "queue_wait_p99": self.queue_wait_p99,
        }


def simulate_replicated(tasks: Sequence[SimTask],
                        policy: sched_lib.Policy, *,
                        R: int = 1,
                        router=None,
                        xi: float = 2.0,
                        per_task_overhead_s: float = 0.0,
                        num_slots: Optional[int] = None,
                        kv_block_size: Optional[int] = None,
                        kv_num_blocks: Optional[int] = None,
                        prompt_len: int = 0,
                        prefill: str = "stall",
                        chunk_size: Optional[int] = None,
                        token_budget: Optional[int] = None,
                        prefix_cache: bool = False,
                        prompt_tokens=None,
                        decode_steps: int = 1,
                        faults=None,
                        obs=None) -> ReplicatedSimResult:
    """R independent continuous-batching replicas behind a front-end
    ``repro_torch.serving.router.Router`` — the simulator twin of
    ``repro_torch.serving.replica.ReplicatedEngine``.

    Every replica is a full ``_ReplicaSim`` with its OWN slot array, KV
    block budget (``kv_num_blocks`` is per replica), chunk scheduler
    and step clock; the driver advances them on a shared virtual clock:
    each turn either PLACES the next arrival (once every working
    replica's clock has reached the arrival time, so the router sees a
    causally consistent view) or ITERATES the furthest-behind working
    replica (ties broken by lowest replica id — the round-robin
    discipline that keeps replica clocks within one iteration of each
    other).  The SAME ``Router`` object the engine front-end drives
    scores ``ReplicaView``s built from live replica state, so placement
    decisions parity-match the engine bit for bit on all-at-t0 traces.

    Observability: the shared ``obs`` bundle is labeled with the active
    replica id around every delivery and iteration (R > 1 only — at
    R=1 the stream stays byte-identical to ``simulate_continuous``);
    a ``route`` event carrying ``{replica, score, policy}`` fires per
    placement.  ``TraceRecorder.parity_events(replica=r)`` recovers one
    replica's stream for per-replica parity assertions.

    Failure-aware serving (``faults`` — a
    ``repro_torch.serving.faults.FaultPlan``): a ``FaultCoordinator`` gates
    every placement through the circuit breaker (with transient
    dispatch faults and half-open probes), each replica runs its
    ``ReplicaFaults`` slice (deadline timeouts, uncertainty-aware
    shedding, straggler slowdowns), and when a replica's local step
    counter reaches its crash point the driver evicts it, collects the
    unfinished requests and re-dispatches them through the coordinator
    (retry/backoff, failover or dead-letter).  ``ReplicatedEngine``
    drives the IDENTICAL coordinator call sequence, so every fault
    decision, counter and trace event parity-matches.  With
    ``faults=None`` no coordinator exists and this function is
    byte-identical to its pre-fault behavior.

    Returns a ``ReplicatedSimResult``: per-replica ``SimResult``s, the
    arrival-ordered placement list, and pool-level latency percentiles
    merged from the per-replica histograms.
    """
    from ..serving.router import ReplicaView, Router

    if R < 1:
        raise ValueError(f"R must be >= 1, got {R}")
    if router is None:
        router = Router(R)
    if router.R != R:
        raise ValueError(f"router expects R={router.R}, got R={R}")
    pending = sorted(tasks, key=lambda t: t.r)
    n_total = len(pending)
    kv_model = kv_block_size is not None and kv_num_blocks is not None
    coord = None
    if faults is not None:
        from ..serving.faults import FaultCoordinator
        if prefill != "stall":
            raise ValueError('faults require prefill="stall"')
        coord = FaultCoordinator(
            faults, R, router, obs,
            kv_num_blocks=kv_num_blocks if kv_model else 0)
    reps = [_ReplicaSim(policy, xi=xi,
                        per_task_overhead_s=per_task_overhead_s,
                        num_slots=num_slots,
                        kv_block_size=kv_block_size,
                        kv_num_blocks=kv_num_blocks,
                        prompt_len=prompt_len, prefill=prefill,
                        chunk_size=chunk_size, token_budget=token_budget,
                        prefix_cache=prefix_cache,
                        prompt_tokens=prompt_tokens,
                        decode_steps=decode_steps,
                        faults=(None if faults is None
                                else faults.for_replica(r)), obs=obs)
            for r in range(R)]
    reps[0].check_fits(pending)
    placements: List[int] = []
    label = obs is not None and R > 1
    i = 0

    def _terminals() -> int:
        return (sum(rep.terminal_count() for rep in reps)
                + (coord.dead_lettered if coord is not None else 0))

    while _terminals() < n_total:
        if coord is not None:
            for r in range(R):
                if not coord.should_crash(r, reps[r].step):
                    continue
                # the crash point: evict + collect survivors on the
                # dead replica, then re-dispatch them through the
                # coordinator (retry/backoff + health-gated failover,
                # dead-letter on budget exhaustion / no target)
                if label:
                    obs.replica_label = r
                try:
                    survivors = reps[r].crash()
                finally:
                    if label:
                        obs.replica_label = None
                coord.note_crash(r)
                descs = [coord.survivor(
                    task_id=_tid(t), u=t.u, cls=_cls(t), arrival=t.r,
                    need=(blocks_for_tokens(
                        prompt_len + max(1, t.true_out_len) - 1,
                        kv_block_size) if kv_model else 0),
                    payload=t) for t in survivors]
                for payload, tgt in coord.redispatch(
                        descs, from_replica=r):
                    tgt_rep = reps[tgt]
                    # causality: a failover delivery cannot precede
                    # the crash it recovers from
                    tgt_rep.now = max(tgt_rep.now, reps[r].now)
                    if label:
                        obs.replica_label = tgt
                    try:
                        tgt_rep.deliver(payload)
                    finally:
                        if label:
                            obs.replica_label = None
        workers = [r for r in range(R) if reps[r].has_work()]
        if i < n_total and all(reps[r].now + 1e-12 >= pending[i].r
                               for r in workers):
            # place the next arrival: every working replica's clock has
            # reached it, so the router's view is causally consistent
            t = pending[i]
            i += 1
            need = blocks_for_tokens(
                prompt_len + max(1, t.true_out_len) - 1,
                kv_block_size) if kv_model else 0
            views = [ReplicaView(replica=r,
                                 is_bulk=router.is_bulk(r),
                                 **reps[r].load())
                     for r in range(R)]
            if coord is not None:
                # health-gated placement; the coordinator emits the
                # route event itself and dead-letters (placement -1)
                # when gating empties the eligible set
                chosen = coord.place(views, task_id=_tid(t), u=t.u,
                                     cls=_cls(t), arrival=t.r,
                                     need=need)
                placements.append(-1 if chosen is None else chosen)
                if chosen is None:
                    continue
            else:
                d = router.place(views, u=t.u, cls=_cls(t), need=need)
                chosen = d.replica
                placements.append(chosen)
                if label:
                    obs.event("route", t.r, _tid(t), None,
                              replica=chosen, score=d.score,
                              policy=d.policy)
            rep = reps[chosen]
            rep.now = max(rep.now, t.r)
            if label:
                obs.replica_label = chosen
            try:
                rep.deliver(t)
            finally:
                if label:
                    obs.replica_label = None
            continue
        if not workers:
            # every replica is down and no arrival is placeable: the
            # crash block above dead-lettered the remaining work, so
            # the terminal count has already reached n_total
            break
        # iterate the furthest-behind working replica (lowest id wins
        # ties) — the shared-clock round-robin discipline
        r = min(workers, key=lambda k: (reps[k].now, k))
        rep = reps[r]
        if label:
            obs.replica_label = r
        try:
            if not rep.iterate():
                rep.advance_idle([pending[i].r] if i < n_total else [])
        finally:
            if label:
                obs.replica_label = None

    ttft_h, itl_h, qw_h = Histogram(), Histogram(), Histogram()
    for rep in reps:
        ttft_h.merge(rep.ttft_h)
        itl_h.merge(rep.itl_h)
        qw_h.merge(rep.qw_h)
    alldone = [t for rep in reps for t in rep.done]
    makespan = (max(t.finish for t in alldone)
                - min(t.r for t in alldone)) if alldone else 0.0
    return ReplicatedSimResult(
        replicas=[rep.result() for rep in reps],
        placements=placements,
        router_policy=router.policy,
        n_tasks=n_total,
        makespan=makespan,
        ttft_p50=ttft_h.quantile(0.50),
        ttft_p90=ttft_h.quantile(0.90),
        ttft_p99=ttft_h.quantile(0.99),
        itl_p50=itl_h.quantile(0.50),
        itl_p90=itl_h.quantile(0.90),
        itl_p99=itl_h.quantile(0.99),
        queue_wait_p50=qw_h.quantile(0.50),
        queue_wait_p90=qw_h.quantile(0.90),
        queue_wait_p99=qw_h.quantile(0.99),
        timed_out=sum(len(rep.timed_out) for rep in reps),
        shed=sum(len(rep.shed_tasks) for rep in reps),
        retries=coord.retries if coord is not None else 0,
        failovers=coord.failovers if coord is not None else 0,
        dead_lettered=coord.dead_lettered if coord is not None else 0,
        failover_placements=(list(coord.failover_placements)
                             if coord is not None else []))


# ---------------------------------------------------------------------------
# one-call experiment helper
# ---------------------------------------------------------------------------


def run_policy(tasks: Sequence[SimTask], policy_name: str,
               persona: Persona, pcfg: sched_lib.PolicyConfig, *,
               xi: float = 2.0, per_task_overhead_s: float = 0.0,
               mode: str = "batch", **continuous_kwargs) -> SimResult:
    """``continuous_kwargs`` (num_slots / kv_block_size / kv_num_blocks /
    prompt_len / prefill / chunk_size / token_budget) forward to
    ``simulate_continuous`` — the block-budget admission model of the
    paged KV cache and the chunked-prefill cost model."""
    import copy
    policy = sched_lib.POLICIES[policy_name](persona, pcfg)
    tasks = [copy.copy(t) for t in tasks]    # fresh timing fields
    if mode != "continuous":
        if continuous_kwargs:
            raise ValueError("kv/slot options only apply to continuous "
                             "mode")
        return simulate(tasks, policy, xi=xi,
                        per_task_overhead_s=per_task_overhead_s)
    return simulate_continuous(tasks, policy, xi=xi,
                               per_task_overhead_s=per_task_overhead_s,
                               **continuous_kwargs)
