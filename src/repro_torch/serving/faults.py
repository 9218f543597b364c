"""Deterministic fault injection + failure-aware serving machinery (port
of ``repro.serving.faults``).

This module is the single source of truth for the failure story shared
VERBATIM by ``ReplicatedEngine`` and the reference simulator's
``simulate_replicated(faults=...)`` (tests/test_torch_faults.py holds the
copy to the reference):
the same ``FaultPlan`` drives both sides at the same decision points so
every new counter and trace event stays bit-for-bit parity-comparable.

Fault model
-----------

* **Crash** (``CrashFault``): a replica dies when its *local* decode
  ``step`` counter — the shared engine/sim iteration coordinate stamped
  on every trace event — reaches ``at_step``.  In-flight requests free
  their KV blocks (``BlockAllocator.free_all``), every unfinished
  request on the replica becomes a *survivor* and is re-dispatched
  through the ``Router`` with capped exponential backoff and a bounded
  retry budget (or dead-lettered when the budget/eligible set is
  exhausted).  A crash fires at most once per replica.
* **Straggler** (``SlowFault``): the replica's per-step latency is
  multiplied by ``factor`` over a step range.  Only the virtual clock is
  affected — wall/time fields are excluded from ``parity_events()`` by
  construction, so slowdowns are parity-safe.
* **Transient dispatch error** (``TransientFault``): the N-th placement
  decision fails once; the request retries against the remaining
  replicas and the breaker records a consecutive failure.

Coordinates are chosen for determinism, *not* wall time: crashes key on
the replica-local step counter, recovery and breaker cooldown key on the
pool-level placement counter.  Both counters advance identically in the
engine and the simulator.

Circuit breaker
---------------

Per-replica health is ``closed`` → (crash / ``failure_threshold``
consecutive transient failures) → ``open`` → after
``cooldown_placements`` further pool placements → ``half_open`` (one
probe placement allowed) → ``closed`` on success / re-``open`` on a dead
probe.  ``ReplicaView.health`` carries the state into ``Router.place``;
all policies skip ``open`` replicas.  When every eligible replica is
open the request is *dead-lettered* (counted, never hung).

Shedding order
--------------

``shed_pass`` runs before admission on both sides: (1) doomed-request
shedding — queued requests already past their class deadline
(``arrival + e2e`` target) time out; (2) under queue pressure
(``len(queue) > ShedPolicy.queue_depth``) bulk classes shed first, then
the highest-``u`` requests predicted to miss their deadline — the
paper's uncertainty signal as a graceful-degradation mechanism.

Everything here is pure host-side bookkeeping: no jax, no engine
imports (mirroring ``router.py``), so the simulator exercises identical
code without touching the device path.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .router import NoEligibleReplica, ReplicaView, Router

__all__ = [
    "CrashFault", "SlowFault", "TransientFault", "RetryPolicy",
    "ShedPolicy", "ReplicaFaults", "FaultPlan", "CircuitBreaker",
    "FaultCoordinator", "shed_pass", "deadline_of", "random_plan",
]


# ---------------------------------------------------------------------------
# fault declarations


@dataclasses.dataclass(frozen=True)
class CrashFault:
    """Replica ``replica`` dies when its local decode-step counter
    reaches ``at_step``.  It becomes probe-eligible again (breaker
    half-open) after ``recover_after_placements`` further pool
    placement decisions (``None`` = stays down forever)."""
    replica: int
    at_step: int
    recover_after_placements: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SlowFault:
    """Multiply per-step latency by ``factor`` for local steps in
    ``[from_step, until_step)``."""
    replica: int
    from_step: int
    until_step: int
    factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class TransientFault:
    """The placement whose pool-level index equals ``at_placement``
    fails once (only when the chosen replica matches ``replica``, any
    replica when ``None``); the request retries elsewhere."""
    at_placement: int
    replica: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with deterministic seeded jitter.

    ``backoff_s(task_id, attempt)`` is a pure function of the seed and
    the (task, attempt) pair — no RNG state, no wall clock — so both
    sides stamp identical backoff fields on ``retry`` events."""
    budget: int = 2
    base_s: float = 0.5
    cap_s: float = 8.0
    jitter_frac: float = 0.25
    seed: int = 0

    def backoff_s(self, task_id, attempt: int) -> float:
        base = min(self.cap_s, self.base_s * (2.0 ** max(0, attempt - 1)))
        mix = zlib.crc32(
            f"{self.seed}:{task_id}:{attempt}".encode()) & 0xFFFFFFFF
        jitter = self.jitter_frac * (mix / float(0x100000000))
        return base * (1.0 + jitter)


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Uncertainty-aware load shedding under sustained queue pressure.

    When the admission queue exceeds ``queue_depth``, shed bulk-class
    requests first (queue order), then the highest-``u`` requests whose
    predicted finish ``now + u * eta_s`` misses their deadline."""
    queue_depth: int = 64
    bulk_classes: Tuple[str, ...] = ()
    eta_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class ReplicaFaults:
    """The per-replica slice of a ``FaultPlan`` threaded into one
    serve/sim loop (``ServingEngine(faults=...)`` / ``_ReplicaSim``)."""
    crash_at_step: Optional[int] = None
    slowdowns: Tuple[SlowFault, ...] = ()
    shed: Optional[ShedPolicy] = None
    deadlines: bool = False

    def slow_factor(self, step: int) -> float:
        f = 1.0
        for s in self.slowdowns:
            if s.from_step <= step < s.until_step:
                f *= s.factor
        return f


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, fully deterministic fault schedule for an R-replica
    pool plus the failure-handling policy knobs."""
    crashes: Tuple[CrashFault, ...] = ()
    slowdowns: Tuple[SlowFault, ...] = ()
    transients: Tuple[TransientFault, ...] = ()
    retry: RetryPolicy = RetryPolicy()
    shed: Optional[ShedPolicy] = None
    deadlines: bool = False
    failover: bool = True
    health_gating: bool = True
    failure_threshold: int = 3
    cooldown_placements: int = 4

    def validate(self, R: int) -> None:
        seen = set()
        for c in self.crashes:
            if not 0 <= c.replica < R:
                raise ValueError(f"crash replica {c.replica} out of "
                                 f"range for R={R}")
            if c.replica in seen:
                raise ValueError(
                    f"multiple crashes for replica {c.replica}; at most "
                    f"one crash per replica is supported")
            seen.add(c.replica)
            if c.at_step < 0:
                raise ValueError("crash at_step must be >= 0")
        for s in self.slowdowns:
            if not 0 <= s.replica < R:
                raise ValueError(f"slowdown replica {s.replica} out of "
                                 f"range for R={R}")
            if s.factor <= 0.0:
                raise ValueError("slowdown factor must be > 0")
        if self.retry.budget < 0:
            raise ValueError("retry budget must be >= 0")

    def crash_for(self, r: int) -> Optional[CrashFault]:
        for c in self.crashes:
            if c.replica == r:
                return c
        return None

    def for_replica(self, r: int) -> ReplicaFaults:
        c = self.crash_for(r)
        return ReplicaFaults(
            crash_at_step=None if c is None else c.at_step,
            slowdowns=tuple(s for s in self.slowdowns if s.replica == r),
            shed=self.shed, deadlines=self.deadlines)


def random_plan(rng, R: int, *, max_step: int = 32,
                seed: int = 0) -> FaultPlan:
    """A random-but-seeded ``FaultPlan`` for property tests: 0..R-1
    crashes at random steps, optional slowdowns/transients."""
    crashes = tuple(
        CrashFault(replica=int(r), at_step=int(rng.integers(0, max_step)),
                   recover_after_placements=(
                       None if rng.random() < 0.5
                       else int(rng.integers(1, 8))))
        for r in sorted(rng.choice(R, size=int(rng.integers(0, R)),
                                   replace=False)))
    slowdowns = tuple(
        SlowFault(replica=int(rng.integers(0, R)),
                  from_step=int(rng.integers(0, max_step)),
                  until_step=int(rng.integers(0, max_step)) + 1,
                  factor=float(1.0 + rng.random() * 3.0))
        for _ in range(int(rng.integers(0, 3))))
    transients = tuple(
        TransientFault(at_placement=int(rng.integers(0, 16)))
        for _ in range(int(rng.integers(0, 3))))
    return FaultPlan(
        crashes=crashes, slowdowns=slowdowns, transients=transients,
        retry=RetryPolicy(budget=int(rng.integers(0, 4)), seed=seed),
        shed=(None if rng.random() < 0.5
              else ShedPolicy(queue_depth=int(rng.integers(1, 8)))),
        deadlines=bool(rng.random() < 0.5),
        failover=bool(rng.random() < 0.8),
        health_gating=bool(rng.random() < 0.8))


# ---------------------------------------------------------------------------
# deadline + shed pass (shared by both serve loops)


def _task_cls(t) -> Optional[str]:
    return getattr(getattr(t, "task", None), "traffic_class", None)


def _task_id(t):
    return getattr(getattr(t, "task", None), "task_id", None)


def deadline_of(arrival: float, cls: Optional[str], slo) -> float:
    """Absolute deadline = arrival + the class's e2e SLO target.

    ``inf`` (no SLO / unknown class without a default target) means the
    request never times out; a negative target (e.g. the
    judgment-invariant ``-1.0`` used by parity tests) dooms it at the
    first pre-admission check regardless of which clock — wall-derived
    engine or model-time sim — is asking."""
    if slo is None:
        return math.inf
    spec = slo.classes.get(slo.resolve(cls or ""))
    if spec is None:
        return math.inf
    return arrival + spec.target("e2e")


def shed_pass(queue: List, *, now: float, step: int,
              rf: Optional[ReplicaFaults], slo, obs):
    """Doomed-request timeouts + pressure shedding, run identically at
    the top of both serve loops.  Returns ``(kept, timed_out, shed)``;
    emits ``timeout``/``shed`` events, ``faults.*`` counters and an
    ``inf`` e2e SLO observation (a recorded miss against any finite
    target) for every dropped request."""
    if rf is None:
        return queue, [], []
    timed: List = []
    kept: List = []
    if rf.deadlines:
        for t in queue:
            if now > deadline_of(t.r, _task_cls(t), slo):
                timed.append(t)
            else:
                kept.append(t)
    else:
        kept = list(queue)
    shed: List = []
    pol = rf.shed
    if pol is not None and len(kept) > pol.queue_depth:
        over = len(kept) - pol.queue_depth
        victims: List = []
        if pol.bulk_classes:
            victims = [t for t in kept
                       if _task_cls(t) in pol.bulk_classes][:over]
        if len(victims) < over:
            vict_ids = {id(t) for t in victims}
            miss = [t for t in kept
                    if id(t) not in vict_ids
                    and now + t.u * pol.eta_s >
                    deadline_of(t.r, _task_cls(t), slo)]
            miss.sort(key=lambda t: (-t.u, _task_id(t)))
            victims += miss[:over - len(victims)]
        vict_ids = {id(t) for t in victims}
        shed = victims
        kept = [t for t in kept if id(t) not in vict_ids]
    if obs is not None:
        for t in timed:
            cls = _task_cls(t)
            obs.event("timeout", now, _task_id(t), step,
                      **({"cls": cls} if cls else {}))
            obs.inc("faults.timed_out")
            obs.slo_observe("e2e", cls or "", now, math.inf)
        for t in shed:
            cls = _task_cls(t)
            reason = "bulk" if cls in (pol.bulk_classes or ()) else "miss"
            obs.event("shed", now, _task_id(t), step, reason=reason,
                      **({"cls": cls} if cls else {}))
            obs.inc("faults.shed")
            obs.slo_observe("e2e", cls or "", now, math.inf)
    return kept, timed, shed


# ---------------------------------------------------------------------------
# circuit breaker


class CircuitBreaker:
    """Per-replica closed/open/half-open routing health, driven by the
    deterministic pool placement counter (never wall time)."""

    def __init__(self, R: int, *, failure_threshold: int = 3,
                 cooldown_placements: int = 4):
        self.R = R
        self.failure_threshold = failure_threshold
        self.cooldown_placements = cooldown_placements
        self.state: List[str] = ["closed"] * R
        self._consecutive = [0] * R
        self._opened_at = [0] * R

    def mark_down(self, r: int, placements: int) -> None:
        self.state[r] = "open"
        self._opened_at[r] = placements

    def record_failure(self, r: int, placements: int) -> None:
        self._consecutive[r] += 1
        if self._consecutive[r] >= self.failure_threshold:
            self.mark_down(r, placements)

    def record_success(self, r: int) -> None:
        self._consecutive[r] = 0

    def close(self, r: int) -> None:
        self.state[r] = "closed"
        self._consecutive[r] = 0

    def health(self, r: int, placements: int) -> str:
        if self.state[r] != "open":
            return "closed"
        if placements - self._opened_at[r] >= self.cooldown_placements:
            return "half_open"
        return "open"


# ---------------------------------------------------------------------------
# the shared coordinator


@dataclasses.dataclass(frozen=True)
class _Survivor:
    """Side-agnostic descriptor for an unfinished request collected off
    a crashed replica; ``payload`` is the side's native object (SimTask
    or Request) handed back to the driver for delivery."""
    task_id: object
    u: float
    cls: Optional[str]
    arrival: float
    need: int
    payload: object


class FaultCoordinator:
    """The pool-level failure state machine, instantiated fresh per run
    and driven through the SAME call sequence by ``ReplicatedEngine``
    and ``simulate_replicated`` — placement gating, transient faults,
    half-open probes, crash bookkeeping, retry/backoff/failover and
    dead-lettering all live here so the two sides cannot drift."""

    def __init__(self, plan: FaultPlan, R: int, router: Router, obs, *,
                 kv_num_blocks: int = 0):
        plan.validate(R)
        self.plan = plan
        self.R = R
        self.router = router
        self.obs = obs
        self.kv_num_blocks = kv_num_blocks
        self.breaker = CircuitBreaker(
            R, failure_threshold=plan.failure_threshold,
            cooldown_placements=plan.cooldown_placements)
        self.placements = 0
        self.attempts: Dict[object, int] = {}
        self.retries = 0
        self.failovers = 0
        self.dead_lettered = 0
        self.dead_letter_ids: List = []
        self.failover_placements: List[Tuple] = []
        self.placed_count = [0] * R
        self.u_sum = [0.0] * R
        self.crashed = [False] * R
        self._crash_placement = [0] * R
        self._transients_fired: Set[int] = set()

    # -- health / functional state -------------------------------------

    def health(self, r: int) -> str:
        if not self.plan.health_gating:
            return "closed"
        return self.breaker.health(r, self.placements)

    def functional(self, r: int) -> bool:
        if not self.crashed[r]:
            return True
        c = self.plan.crash_for(r)
        if c is None or c.recover_after_placements is None:
            return False
        return (self.placements - self._crash_placement[r]
                >= c.recover_after_placements)

    def should_crash(self, r: int, step: int) -> bool:
        c = self.plan.crash_for(r)
        return (c is not None and not self.crashed[r]
                and step >= c.at_step)

    def note_crash(self, r: int) -> None:
        self.crashed[r] = True
        self._crash_placement[r] = self.placements
        self.breaker.mark_down(r, self.placements)

    # -- placement -----------------------------------------------------

    def ledger_views(self) -> List[ReplicaView]:
        """Deterministic assignment-ledger views (counts of requests
        ever assigned, full KV pool) — the same bookkeeping the engine
        front-end places with, used by BOTH sides for failover
        re-dispatch so the decision is temporally well-defined."""
        return [ReplicaView(
            replica=r, queued=self.placed_count[r], active=0,
            free_blocks=self.kv_num_blocks,
            num_blocks=self.kv_num_blocks, u_load=self.u_sum[r],
            is_bulk=r in self.router.bulk_replicas)
            for r in range(self.R)]

    def place(self, views: Sequence[ReplicaView], *, task_id, u: float,
              cls: Optional[str], arrival: float,
              need: int) -> Optional[int]:
        """Health-gated placement with transient faults and half-open
        probes.  Emits the ``route`` event itself; returns the target
        replica or ``None`` when the request dead-letters (already
        counted + emitted)."""
        excluded: Set[int] = set()
        while True:
            hviews = []
            for v in views:
                h = ("open" if v.replica in excluded
                     else self.health(v.replica))
                if h != v.health:
                    v = dataclasses.replace(v, health=h)
                hviews.append(v)
            try:
                d = self.router.place(hviews, u=u, cls=cls, need=need)
            except NoEligibleReplica:
                self._dead_letter(task_id, cls, arrival,
                                  reason="no_replica")
                return None
            r = d.replica
            if self._transient_fires(r):
                self.breaker.record_failure(r, self.placements)
                if not self._note_retry(task_id, cls, arrival,
                                        reason="transient"):
                    return None
                excluded.add(r)
                continue
            if not self.functional(r):
                # dead probe (gating on) or dispatch to a dead replica
                # (gating off): the breaker (re)opens and the request
                # retries against the remaining replicas
                self.breaker.mark_down(r, self.placements)
                if not self._note_retry(task_id, cls, arrival,
                                        reason="down"):
                    return None
                excluded.add(r)
                continue
            if self.breaker.state[r] == "open":
                # functional again: the half-open probe succeeded
                self.breaker.close(r)
                if self.obs is not None:
                    self.obs.event("replica_up", arrival, None, None,
                                   replica=r)
            self.breaker.record_success(r)
            if self.obs is not None:
                self.obs.event("route", arrival, task_id, None,
                               replica=r, score=d.score, policy=d.policy)
            self.placements += 1
            self.placed_count[r] += 1
            self.u_sum[r] += u
            return r

    def _transient_fires(self, r: int) -> bool:
        for i, tf in enumerate(self.plan.transients):
            if (i not in self._transients_fired
                    and tf.at_placement == self.placements
                    and (tf.replica is None or tf.replica == r)):
                self._transients_fired.add(i)
                return True
        return False

    # -- retry / failover / dead-letter --------------------------------

    def _note_retry(self, task_id, cls, arrival, *, reason: str) -> bool:
        a = self.attempts.get(task_id, 0) + 1
        if not self.plan.failover or a > self.plan.retry.budget:
            self._dead_letter(task_id, cls, arrival, reason=reason)
            return False
        self.attempts[task_id] = a
        self.retries += 1
        if self.obs is not None:
            self.obs.event(
                "retry", arrival, task_id, None, attempt=a,
                reason=reason,
                backoff_s=self.plan.retry.backoff_s(task_id, a))
            self.obs.inc("faults.retries")
        return True

    def _dead_letter(self, task_id, cls, arrival, *,
                     reason: str) -> None:
        self.dead_lettered += 1
        self.dead_letter_ids.append(task_id)
        if self.obs is not None:
            self.obs.event("dead_letter", arrival, task_id, None,
                           reason=reason, **({"cls": cls} if cls else {}))
            self.obs.inc("faults.dead_lettered")
            self.obs.slo_observe("e2e", cls or "", arrival, math.inf)

    def redispatch(self, survivors: Sequence[_Survivor], *,
                   from_replica: int) -> List[Tuple[object, int]]:
        """Retry/backoff + failover for the unfinished requests of a
        crashed replica.  Returns ``[(payload, target_replica), ...]``
        in deterministic (arrival, task_id) order for the driver to
        deliver; budget-exhausted or all-down requests dead-letter."""
        for s in survivors:
            self.placed_count[from_replica] -= 1
            self.u_sum[from_replica] -= s.u
        out: List[Tuple[object, int]] = []
        for s in sorted(survivors, key=lambda s: (s.arrival,
                                                  str(s.task_id))):
            if not self._note_retry(s.task_id, s.cls, s.arrival,
                                    reason="crash"):
                continue
            tgt = self.place(self.ledger_views(), task_id=s.task_id,
                             u=s.u, cls=s.cls, arrival=s.arrival,
                             need=s.need)
            if tgt is None:
                continue
            self.failovers += 1
            self.failover_placements.append(
                (s.task_id, from_replica, tgt))
            if self.obs is not None:
                self.obs.event("failover", s.arrival, s.task_id, None,
                               src=from_replica, dst=tgt,
                               attempt=self.attempts[s.task_id])
                self.obs.inc("faults.failovers")
            out.append((s.payload, tgt))
        return out

    def survivor(self, *, task_id, u, cls, arrival, need,
                 payload) -> _Survivor:
        return _Survivor(task_id=task_id, u=u, cls=cls, arrival=arrival,
                         need=need, payload=payload)

    def counters(self) -> Dict[str, int]:
        return {"retries": self.retries, "failovers": self.failovers,
                "dead_lettered": self.dead_lettered}
