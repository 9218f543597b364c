"""Uncertainty-aware request router over R serving replicas (port of
``repro.serving.router``).

RT-LM's system-level scheduler (paper §5) becomes real at pod scale:
multiple engine replicas behind a placement layer.  ``Router`` is that
layer — a pure, deterministic policy object with NO engine imports, so
the same configuration can be driven by the real front-end
(``repro_torch.serving.replica.ReplicatedEngine``) and by the reference
simulator (``repro.core.simulator.simulate_replicated``); placement
decisions parity-match bit for bit because both sides feed it
bitwise-identical ``ReplicaView``s (tests/test_torch_router.py holds the
copy to the reference).

Three policies (``ROUTER_POLICIES``):

  * ``round_robin`` — cycle through the eligible replicas (one cursor
    per eligibility group, so a bulk slice cycles independently);
  * ``least_queue`` — fewest placed-but-unfinished requests, ties to
    the lowest replica id;
  * ``rtlm``        — the headline uncertainty-aware score (lower is
    better): predicted-uncertainty-weighted queue cost plus KV-pool
    reservation pressure,

        score = (1 + (u_load + u) / u_scale) * (queued + 1)
                + need / max(free_blocks, 1)

    where ``u`` is the arriving request's predicted output length
    (the offline profile's uncertainty proxy), ``u_load`` the sum of
    predicted lengths already placed, and ``need`` the arrival's
    worst-case block reservation (``kvcache.blocks_for_tokens`` — the
    admission gate's own formula).  The score is monotone increasing
    in ``u`` and decreasing in ``free_blocks``: high-uncertainty
    requests are steered away from loaded, memory-tight replicas —
    the paper's uncertainty-aware prioritization applied to placement.

Bulk replica slice (the paper's dynamic-consolidation/offload lane):
``bulk_replicas`` designates low-priority replicas and
``bulk_classes`` the traffic classes confined to them; interactive
(non-bulk) classes are NEVER placed on a bulk replica, so batch
traffic cannot inflate the interactive tail.

Admissibility gate: an arrival whose reservation can never fit a
replica's pool (``need > num_blocks``) is ineligible there — the
router refuses placements the engine's admission gate would deadlock
on.

Health gating (``serving.faults``): ``ReplicaView.health`` carries the
circuit-breaker state (``closed``/``half_open``/``open``); every policy
skips ``open`` replicas, and a ``half_open`` replica is eligible as a
probe.  When gating (or admissibility) empties the eligible set,
``place`` raises ``NoEligibleReplica`` — a ``ValueError`` subclass so
pre-fault callers are unchanged — which the fault coordinator converts
into a counted dead-letter outcome instead of a hang.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

#: placement policies, in documentation order
ROUTER_POLICIES = ("round_robin", "least_queue", "rtlm")


class NoEligibleReplica(ValueError):
    """No replica can take this request (bulk-slice eligibility,
    admissibility and health gating left an empty set)."""


@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """One replica's load as the router sees it at placement time.

    The simulator builds views from live ``_ReplicaSim`` state
    (``_ReplicaSim.load()``); the engine front-end builds them from its
    placement bookkeeping — on all-at-t0 traces (every placement before
    any engine work) the two are bitwise identical, which is what makes
    routing decisions engine-vs-sim parity-comparable.
    """

    replica: int
    queued: int = 0        # placed-but-unfinished (queue + in-flight)
    active: int = 0        # occupied decode slots
    free_blocks: int = 0   # KV-pool headroom in blocks (0 if unpaged)
    num_blocks: int = 0    # KV-pool capacity (admissibility gate;
    #                        0 = unpaged, gate inapplicable)
    u_load: float = 0.0    # summed predicted output lengths in flight
    is_bulk: bool = False  # member of the low-priority bulk slice
    health: str = "closed"  # circuit-breaker state (serving.faults):
    #                         "open" replicas are skipped by every policy


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Placement outcome: chosen replica, the policy's score for it
    (policy-specific units: rtlm cost, queue depth, or the round-robin
    cursor's pick), and the policy name — the ``route`` event payload."""

    replica: int
    score: float
    policy: str


class Router:
    """Pluggable placement policy over R replicas (see module docs).

    Stateless per decision except the round-robin cursors, so one
    instance must NOT be shared between an engine run and a sim run
    that are meant to parity-match — give each side a fresh instance
    with identical configuration.
    """

    def __init__(self, R: int, policy: str = "round_robin", *,
                 bulk_replicas: Sequence[int] = (),
                 bulk_classes: Sequence[str] = (),
                 u_scale: float = 8.0):
        if R < 1:
            raise ValueError(f"R must be >= 1, got {R}")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"expected one of {ROUTER_POLICIES}")
        bulk = sorted({int(b) for b in bulk_replicas})
        if any(b < 0 or b >= R for b in bulk):
            raise ValueError(f"bulk_replicas {bulk} out of range for "
                             f"R={R}")
        if bulk and len(bulk) == R:
            raise ValueError("bulk_replicas covers every replica — "
                             "interactive classes would have no "
                             "placement target")
        if u_scale <= 0:
            raise ValueError(f"u_scale must be > 0, got {u_scale}")
        self.R = R
        self.policy = policy
        self.bulk_replicas: Tuple[int, ...] = tuple(bulk)
        self.bulk_classes: Tuple[str, ...] = tuple(bulk_classes)
        self.u_scale = float(u_scale)
        self._rr_cursor: Dict[Tuple[int, ...], int] = {}

    # ------------------------------------------------------------------
    def is_bulk(self, replica: int) -> bool:
        return replica in self.bulk_replicas

    def eligible(self, cls: str = "") -> List[int]:
        """Replica ids a request of traffic class ``cls`` may be placed
        on: bulk classes get the bulk slice, everything else the
        non-bulk replicas; with no slice configured, all replicas."""
        if not self.bulk_replicas:
            return list(range(self.R))
        if cls and cls in self.bulk_classes:
            return list(self.bulk_replicas)
        return [r for r in range(self.R)
                if r not in self.bulk_replicas]

    def score(self, view: ReplicaView, *, u: float = 0.0,
              need: int = 0) -> float:
        """The rtlm placement cost (lower is better) — monotone
        increasing in ``u`` and ``u_load``, decreasing in
        ``free_blocks`` (see module docs for the formula)."""
        qcost = ((1.0 + (view.u_load + u) / self.u_scale)
                 * (view.queued + 1.0))
        return qcost + need / float(max(view.free_blocks, 1))

    # ------------------------------------------------------------------
    def place(self, views: Sequence[ReplicaView], *, u: float = 0.0,
              cls: str = "", need: int = 0) -> RouteDecision:
        """Choose a replica for one arrival.

        ``views`` — one ``ReplicaView`` per replica, index-aligned;
        ``u`` — the arrival's predicted output length;
        ``cls`` — its traffic class (bulk-slice eligibility);
        ``need`` — its worst-case block reservation
        (``kvcache.blocks_for_tokens``; 0 when unpaged).
        """
        if len(views) != self.R:
            raise ValueError(f"expected {self.R} views, got "
                             f"{len(views)}")
        elig = self.eligible(cls)
        # health gate: circuit-broken replicas take no traffic
        # (half-open replicas stay eligible as probes)
        elig = [r for r in elig if views[r].health != "open"]
        if need > 0:
            # admissibility: a pool that can never hold the reservation
            # is out (num_blocks == 0 marks an unpaged replica — no gate)
            elig = [r for r in elig
                    if views[r].num_blocks <= 0
                    or need <= views[r].num_blocks]
        if not elig:
            raise NoEligibleReplica(
                f"no eligible replica for cls={cls!r} need={need} "
                f"(bulk_replicas={self.bulk_replicas}, "
                f"bulk_classes={self.bulk_classes})")
        if self.policy == "round_robin":
            group = tuple(elig)
            k = self._rr_cursor.get(group, 0)
            r = elig[k % len(elig)]
            self._rr_cursor[group] = (k + 1) % len(elig)
            return RouteDecision(replica=r, score=float(r),
                                 policy=self.policy)
        if self.policy == "least_queue":
            r = min(elig, key=lambda k: (views[k].queued, k))
            return RouteDecision(replica=r,
                                 score=float(views[r].queued),
                                 policy=self.policy)
        # rtlm: lowest uncertainty-weighted cost, ties to lowest id
        r = min(elig, key=lambda k: (self.score(views[k], u=u,
                                                need=need), k))
        return RouteDecision(replica=r,
                             score=self.score(views[r], u=u, need=need),
                             policy=self.policy)
