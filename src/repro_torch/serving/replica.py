"""Multi-replica serving: R independent engines behind the Router (port of
``repro.serving.replica``).

``ReplicatedEngine`` owns R ``ServingEngine`` instances — each with
its OWN KV pool, ``BlockAllocator``, ``PrefixCache`` and continuous
decode loop (nothing is shared but the model parameters, the policy
object and the observability bundle) — and a front-end
``serving.router.Router`` that places every arriving request on exactly
one replica.

Placement protocol (the engine half of the parity discipline with
``repro.core.simulator.simulate_replicated``):

  1. requests are sorted by arrival (stable, as every serve loop does);
  2. for each request, the front-end computes the router inputs the
     simulator computes for its twin task — ``u`` from the offline
     profile's predictor (the engine's own ``_to_sim_task`` recipe) and
     ``need`` from the paged admission gate's reservation formula
     (``blocks_for_tokens(input_bucket + cap - 1, block_size)``);
  3. ``Router.place`` scores per-replica ``ReplicaView``s built from
     placement bookkeeping (placed counts, running ``u_load`` sums,
     pool capacities).  On all-at-t0 traces every placement precedes
     any engine work, so these views are bitwise identical to the
     simulator's live views and the decisions parity-match;
  4. a ``route`` event ``{replica, score, policy}`` fires per placement
     (R > 1 only — R=1 traces stay byte-identical to single-engine);
  5. each replica then serves its group with ``obs.replica_label`` set
     (R > 1 only), so every event/counter/SLO observation lands in that
     replica's parity substream
     (``TraceRecorder.parity_events(replica=r)``).

Device mapping is metadata, not magic: ``replica_devices()`` exposes
``repro_torch.launch.mesh.replica_groups`` — contiguous data-parallel
device slices when the host has >= R devices, shared-device replicas
otherwise (R engine instances time-sharing one card, or the CPU, which is
exactly what this in-process front-end models).  Every engine runs on the
``device`` it was given (``engine_kwargs``); as in the reference, no
replica is placed on its group.  On one card the R engines share the
parameters, and each owns its page pool, its allocator and its CUDA
graphs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..kvcache import blocks_for_tokens
from ..obs import Observability

from .engine import Request, ServingEngine
from .router import ReplicaView, Router


class ReplicatedEngine:
    """R independent ``ServingEngine`` replicas behind one ``Router``.

    ``engine_kwargs`` forward verbatim to every replica's
    ``ServingEngine`` constructor, ``device`` included (equal pools —
    ``kv_num_blocks`` is PER replica, as in ``simulate_replicated``).
    """

    def __init__(self, params, cfg, policy, profile, *,
                 replicas: int = 1,
                 router: Optional[Router] = None,
                 faults=None,
                 obs: Optional[Observability] = None,
                 **engine_kwargs):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.R = int(replicas)
        self.router = router if router is not None else Router(self.R)
        if self.router.R != self.R:
            raise ValueError(f"router expects R={self.router.R}, got "
                             f"replicas={self.R}")
        self.obs = obs
        self.profile = profile
        # failure-aware serving (serving.faults.FaultPlan): each
        # replica gets its per-replica fault slice; the pool-level
        # machinery (health-gated placement, retry/failover,
        # dead-letter) runs in _serve_faulted
        self.faults = faults
        if faults is not None:
            faults.validate(self.R)
        self.engines = [ServingEngine(params, cfg, policy, profile,
                                      obs=obs,
                                      faults=(None if faults is None
                                              else faults.for_replica(r)),
                                      **engine_kwargs)
                        for r in range(self.R)]
        self.placements: List[int] = []

    # ------------------------------------------------------------------
    def replica_devices(self) -> List[list]:
        """Device group per replica (``launch.mesh.replica_groups``): the
        visible cards for engines on the card, the engines' own device
        otherwise."""
        from ..launch.mesh import replica_groups
        dev = self.engines[0].device
        return replica_groups(self.R,
                              devices=None if dev.type == "cuda" else [dev])

    def _need(self, req: Request) -> int:
        """The arrival's worst-case block reservation — the SAME
        formula the paged admission gate applies (0 when unpaged)."""
        eng = self.engines[0]
        if eng.kv != "paged":
            return 0
        return blocks_for_tokens(eng.input_bucket + eng._cap(req) - 1,
                                 eng.kv_block_size)

    # ------------------------------------------------------------------
    def serve(self, requests: Sequence[Request]) -> Dict:
        """Place every request, then serve each replica's group.

        Returns a pool-level result dict wrapping the per-replica
        ``ServingEngine`` results (``None`` for a replica that received
        no requests — an idle replica runs nothing).
        """
        if self.faults is not None:
            return self._serve_faulted(requests)
        reqs = sorted(requests, key=lambda q: q.arrival)
        label = self.obs is not None and self.R > 1
        placed: List[List[Request]] = [[] for _ in range(self.R)]
        u_placed: List[List[float]] = [[] for _ in range(self.R)]
        placements: List[int] = []
        for req in reqs:
            # router inputs, computed exactly as the simulator twin
            # computes them for its SimTask
            u = float(max(self.profile.predictor.score(req.text), 0.0))
            need = self._need(req)
            views = [ReplicaView(
                replica=r,
                queued=len(placed[r]),
                active=0,
                free_blocks=(self.engines[r].kv_num_blocks
                             if self.engines[r].kv == "paged" else 0),
                num_blocks=(self.engines[r].kv_num_blocks
                            if self.engines[r].kv == "paged" else 0),
                u_load=float(sum(u_placed[r])),
                is_bulk=self.router.is_bulk(r))
                for r in range(self.R)]
            d = self.router.place(views, u=u, cls=req.traffic_class,
                                  need=need)
            placements.append(d.replica)
            if label:
                self.obs.event("route", req.arrival, req.task_id, None,
                               replica=d.replica, score=d.score,
                               policy=d.policy)
            placed[d.replica].append(req)
            u_placed[d.replica].append(u)
        self.placements = placements

        results: List[Optional[Dict]] = []
        for r in range(self.R):
            if not placed[r]:
                results.append(None)
                continue
            if label:
                self.obs.replica_label = r
            try:
                results.append(self.engines[r].serve(placed[r]))
            finally:
                if self.obs is not None:
                    self.obs.replica_label = None
        return {
            "mode": "replicated",
            "replicas": self.R,
            "router_policy": self.router.policy,
            "n_tasks": len(reqs),
            "placements": placements,
            "placement_counts": [len(g) for g in placed],
            "per_replica": results,
            "completion_orders": [
                res["completion_order"] if res is not None else []
                for res in results],
            "rejected_for_memory": sum(
                res["rejected_for_memory"] for res in results
                if res is not None),
            "fallback_events": sum(
                res["fallback_events"] for res in results
                if res is not None),
        }

    # ------------------------------------------------------------------
    def _serve_faulted(self, requests: Sequence[Request]) -> Dict:
        """Failure-aware pool serve: coordinator-gated placement, then
        ROUND-based serving — round k+1 serves the failover groups of
        the replicas that crashed in round k, with ``step_offset``
        continuing each target's step coordinate where its previous
        serve stopped — until no crash adds new work.  Crashes are
        one-shot per replica, so at most R+1 rounds run.  This drives
        the IDENTICAL ``FaultCoordinator`` call sequence as
        ``simulate_replicated(faults=...)``: placement gating, retry/
        backoff, failover and dead-letter decisions — and their events
        and counters — parity-match bit for bit.
        """
        from .faults import FaultCoordinator

        reqs = sorted(requests, key=lambda q: q.arrival)
        label = self.obs is not None and self.R > 1
        eng0 = self.engines[0]
        coord = FaultCoordinator(
            self.faults, self.R, self.router, self.obs,
            kv_num_blocks=(eng0.kv_num_blocks
                           if eng0.kv == "paged" else 0))
        req_u: Dict = {}
        placements: List[int] = []
        groups: List[List[Request]] = [[] for _ in range(self.R)]
        for req in reqs:
            u = float(max(self.profile.predictor.score(req.text), 0.0))
            req_u[req.task_id] = u
            # the coordinator's ledger views ARE this front-end's
            # placement bookkeeping (placed counts, u sums, full
            # pools); it emits the route event and dead-letters
            # (placement -1) when gating empties the eligible set
            tgt = coord.place(coord.ledger_views(), task_id=req.task_id,
                              u=u, cls=req.traffic_class,
                              arrival=req.arrival, need=self._need(req))
            placements.append(-1 if tgt is None else tgt)
            if tgt is not None:
                groups[tgt].append(req)
        self.placements = placements

        merged: List[List[Dict]] = [[] for _ in range(self.R)]
        step_offsets = [0] * self.R
        next_groups = groups
        while any(next_groups):
            cur, next_groups = next_groups, [[] for _ in range(self.R)]
            for r in range(self.R):
                if not cur[r]:
                    continue
                if coord.crashed[r] and not coord.functional(r):
                    # the target died in an earlier round before this
                    # failover group could run: the group re-enters the
                    # coordinator (attempt N+1) exactly as the
                    # simulator's crash survivors do — re-placed on a
                    # functional replica or dead-lettered
                    descs = [coord.survivor(
                        task_id=q.task_id, u=req_u[q.task_id],
                        cls=q.traffic_class, arrival=q.arrival,
                        need=self._need(q), payload=q)
                        for q in cur[r]]
                    for payload, tgt in coord.redispatch(
                            descs, from_replica=r):
                        next_groups[tgt].append(payload)
                    continue
                if label:
                    self.obs.replica_label = r
                try:
                    res = self.engines[r].serve(
                        cur[r], step_offset=step_offsets[r])
                finally:
                    if self.obs is not None:
                        self.obs.replica_label = None
                merged[r].append(res)
                step_offsets[r] = res["final_step"]
                if res["crashed"] and not coord.crashed[r]:
                    coord.note_crash(r)
                    survivors = list(self.engines[r].survivors)
                    descs = [coord.survivor(
                        task_id=q.task_id, u=req_u[q.task_id],
                        cls=q.traffic_class, arrival=q.arrival,
                        need=self._need(q), payload=q)
                        for q in survivors]
                    for payload, tgt in coord.redispatch(
                            descs, from_replica=r):
                        next_groups[tgt].append(payload)

        results = [self._merge_rounds(rl) for rl in merged]
        return {
            "mode": "replicated",
            "replicas": self.R,
            "router_policy": self.router.policy,
            "n_tasks": len(reqs),
            "placements": placements,
            "placement_counts": [placements.count(r)
                                 for r in range(self.R)],
            "per_replica": results,
            "completion_orders": [
                res["completion_order"] if res is not None else []
                for res in results],
            "rejected_for_memory": sum(
                res["rejected_for_memory"] for res in results
                if res is not None),
            "fallback_events": sum(
                res["fallback_events"] for res in results
                if res is not None),
            "timed_out": sum(res["timed_out"] for res in results
                             if res is not None),
            "shed": sum(res["shed"] for res in results
                        if res is not None),
            "retries": coord.retries,
            "failovers": coord.failovers,
            "dead_lettered": coord.dead_lettered,
            "failover_placements": list(coord.failover_placements),
        }

    @staticmethod
    def _merge_rounds(rounds: List[Dict]) -> Optional[Dict]:
        """Fold one replica's per-round serve results (its initial
        group plus any failover rounds) into a single result dict: the
        trailing round's engine-state fields, with the completion /
        terminal accounting concatenated in round order."""
        if not rounds:
            return None
        if len(rounds) == 1:
            return rounds[0]
        out = dict(rounds[-1])
        out["n_tasks"] = sum(res["n_tasks"] for res in rounds)
        out["tasks"] = [t for res in rounds for t in res["tasks"]]
        out["completion_order"] = [tid for res in rounds
                                   for tid in res["completion_order"]]
        for key in ("timed_out", "shed", "rejected_for_memory",
                    "fallback_events"):
            out[key] = sum(res[key] for res in rounds)
        for key in ("timed_out_ids", "shed_ids", "survivor_ids"):
            out[key] = [tid for res in rounds for tid in res[key]]
        return out
