"""PyTorch port: fault injection and failure-aware serving
(``repro_torch.serving.faults``, ``ServingEngine(faults=...)``,
``ReplicatedEngine(faults=...)``) against the reference.

  * the copies — ``RetryPolicy.backoff_s``, the circuit breaker's
    transitions, ``FaultPlan.validate`` / ``for_replica``, ``random_plan``
    for several seeds, ``deadline_of``, and ``shed_pass`` and
    ``FaultCoordinator`` call sequences on identical inputs, event for
    event and counter for counter;
  * the engines against ``simulate_replicated`` / ``simulate_continuous``
    (the reference's tests/test_faults.py grid): crash failover at R in
    {2, 4} x {fifo, rt-lm}, on the paged pool and once on the contiguous
    cache; a transient dispatch fault; breaker recovery with
    ``replica_up``; deadline timeouts; uncertainty shedding; every replica
    down; no fault key, event or counter without a plan; the validation
    errors — placements, failover placements, fault counts and ids,
    per-replica parity events, counters and SLO counts bit for bit;
  * one R = 2 crash case token for token against the JAX
    ``ReplicatedEngine`` (scoring with the port's m_theta);
  * a serve that completes nothing (crashed at step 0, or every request
    timed out) reports zeros, as the JAX engine does;
  * the ``CompletionWorker`` re-raises a poisoned readback at ``collect``
    and survives it, and a poisoned decode unwinds ``serve`` with no
    worker left behind.
"""

import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import priority as jprio  # noqa: E402
from repro.core import simulator  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving import replica as jreplica  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import pipeline as tpipeline  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.serving.replica import ReplicatedEngine  # noqa: E402

BLOCKS = 64                      # per-replica pool (generous: no rejects)
FAULT_KINDS = ("timeout", "shed", "retry", "failover", "replica_down",
               "replica_up", "dead_letter")
PAGED = dict(mode="continuous", kv="paged", kv_block_size=es.BS,
             num_slots=es.SLOTS, kv_num_blocks=BLOCKS)
CONTIGUOUS = dict(mode="continuous", kv="contiguous", num_slots=es.SLOTS)
#: a faulted pool's result keys, in the reference's order
POOL_KEYS = ["mode", "replicas", "router_policy", "n_tasks", "placements",
             "placement_counts", "per_replica", "completion_orders",
             "rejected_for_memory", "fallback_events", "timed_out", "shed",
             "retries", "failovers", "dead_lettered", "failover_placements"]


# ---------------------------------------------------------------------------
# the copies against the reference
# ---------------------------------------------------------------------------


def test_backoff_is_the_references():
    for seed in (0, 7, 123):
        for kw in (dict(), dict(budget=3, base_s=0.5, cap_s=4.0,
                                jitter_frac=0.25),
                   dict(base_s=0.1, cap_s=100.0, jitter_frac=1.0)):
            tp = tfaults.RetryPolicy(seed=seed, **kw)
            jp = jfaults.RetryPolicy(seed=seed, **kw)
            for tid in (0, 11, 12, "a", (3, 4)):
                for attempt in range(0, 8):
                    assert tp.backoff_s(tid, attempt) \
                        == jp.backoff_s(tid, attempt)


def test_breaker_transitions_are_the_references():
    """A seeded random run of breaker operations: the same states and
    health answers after every one."""
    rng = np.random.default_rng(3)
    tb = tfaults.CircuitBreaker(3, failure_threshold=2,
                                cooldown_placements=3)
    jb = jfaults.CircuitBreaker(3, failure_threshold=2,
                                cooldown_placements=3)
    placements = 0
    seen = set()
    for _ in range(400):
        op = int(rng.integers(0, 5))
        r = int(rng.integers(0, 3))
        placements += int(rng.integers(0, 2))
        for b in (tb, jb):
            if op == 0:
                b.mark_down(r, placements)
            elif op == 1:
                b.record_failure(r, placements)
            elif op == 2:
                b.record_success(r)
            elif op == 3:
                b.close(r)
        assert tb.state == jb.state
        assert tb._consecutive == jb._consecutive
        h = [tb.health(k, placements) for k in range(3)]
        assert h == [jb.health(k, placements) for k in range(3)]
        seen.update(h)
    assert seen == {"closed", "open", "half_open"}


def _plan(mod, **kw):
    """A ``FaultPlan`` of ``mod`` from plain tuples: crashes
    ``(replica, at_step[, recover])``, slowdowns ``(replica, from, until,
    factor)``, transients ``(at_placement[, replica])``."""
    crashes = tuple(mod.CrashFault(*c) for c in kw.pop("crashes", ()))
    slowdowns = tuple(mod.SlowFault(*s) for s in kw.pop("slowdowns", ()))
    transients = tuple(mod.TransientFault(*t)
                       for t in kw.pop("transients", ()))
    if "retry" in kw:
        kw["retry"] = mod.RetryPolicy(**kw["retry"])
    if "shed" in kw:
        kw["shed"] = mod.ShedPolicy(**kw["shed"])
    return mod.FaultPlan(crashes=crashes, slowdowns=slowdowns,
                         transients=transients, **kw)


PLANS = [
    dict(crashes=((0, 2),)),
    dict(crashes=((5, 2),)),
    dict(crashes=((0, 2), (0, 9))),
    dict(crashes=((0, -1),)),
    dict(slowdowns=((9, 0, 4, 2.0),)),
    dict(slowdowns=((0, 0, 4, 0.0),)),
    dict(retry=dict(budget=-1)),
    dict(crashes=((1, 4),), slowdowns=((0, 2, 6, 3.0), (1, 0, 2, 2.0)),
         shed=dict(queue_depth=8), deadlines=True),
    dict(crashes=((0, 3, 2), (1, 1)), transients=((1,), (4, 0)),
         retry=dict(budget=3, seed=5), failover=False, health_gating=False,
         failure_threshold=1, cooldown_placements=2),
]


@pytest.mark.parametrize("kw", PLANS)
def test_plan_validate_and_slices_are_the_references(kw):
    tp, jp = _plan(tfaults, **dict(kw)), _plan(jfaults, **dict(kw))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    errs = []
    for p in (tp, jp):
        try:
            p.validate(2)
            errs.append(None)
        except ValueError as exc:
            errs.append(str(exc))
    assert errs[0] == errs[1]
    if errs[0] is None:
        for r in range(2):
            ts, js = tp.for_replica(r), jp.for_replica(r)
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            for step in range(10):
                assert ts.slow_factor(step) == js.slow_factor(step)


@pytest.mark.parametrize("R", [1, 2, 4])
def test_random_plan_is_the_references(R):
    for seed in range(12):
        tp = tfaults.random_plan(np.random.default_rng(seed), R, seed=seed)
        jp = jfaults.random_plan(np.random.default_rng(seed), R, seed=seed)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        tp.validate(R)


def test_deadline_of_is_the_references():
    targets = {"rush": -1.0, "slow": 2.5, "free": math.inf}
    tob = tobs.Observability(slo={k: tobs.SLOSpec(e2e_s=v)
                                  for k, v in targets.items()})
    job = jobs.Observability(slo={k: jobs.SLOSpec(e2e_s=v)
                                  for k, v in targets.items()})
    for cls in ("rush", "slow", "free", "other", "", None):
        for arrival in (0.0, 1.5):
            assert tfaults.deadline_of(arrival, cls, tob.slo) \
                == jfaults.deadline_of(arrival, cls, job.slo)
    assert tfaults.deadline_of(1.0, "rush", None) == math.inf


def _qtask(i, u, cls, arrival=0.0):
    task = types.SimpleNamespace(task_id=i, traffic_class=cls)
    return jprio.SimTask(task=task, u=float(u), r=float(arrival), d=1e9,
                         input_len=8.0, true_out_len=2)


@pytest.mark.parametrize("seed", range(6))
def test_shed_pass_is_the_references(seed):
    """Random queues under random shed policies and deadlines: the same
    kept, timed-out and shed requests, events, counters and SLO counts."""
    rng = np.random.default_rng(seed)
    classes = ["rush", "batch", "calm", ""]
    specs = {"rush": dict(e2e_s=-1.0), "batch": dict(e2e_s=0.5),
             "calm": dict()}
    tob = tobs.Observability(slo={k: tobs.SLOSpec(**v)
                                  for k, v in specs.items()})
    job = jobs.Observability(slo={k: jobs.SLOSpec(**v)
                                  for k, v in specs.items()})
    for it in range(10):
        queue = [_qtask(100 * it + k, rng.uniform(0, 20),
                        classes[int(rng.integers(0, 4))],
                        rng.uniform(0.0, 1.0))
                 for k in range(int(rng.integers(0, 12)))]
        shed = None
        if rng.random() < 0.7:
            shed = dict(queue_depth=int(rng.integers(0, 6)),
                        bulk_classes=("batch",) if rng.random() < 0.5
                        else (), eta_s=float(rng.choice([0.0, 0.05])))
        deadlines = bool(rng.random() < 0.5)
        now = float(rng.uniform(0.0, 2.0))
        out = []
        for mod, ob in ((tfaults, tob), (jfaults, job)):
            rf = mod.ReplicaFaults(
                shed=None if shed is None else mod.ShedPolicy(**shed),
                deadlines=deadlines)
            kept, timed, dropped = mod.shed_pass(
                list(queue), now=now, step=it, rf=rf, slo=ob.slo, obs=ob)
            out.append([[t.task.task_id for t in x]
                        for x in (kept, timed, dropped)])
        assert out[0] == out[1]
    assert tob.trace.parity_events() == job.trace.parity_events()
    assert tob.metrics.counters() == job.metrics.counters()
    assert tob.slo.parity_counters() == job.slo.parity_counters()
    q = [_qtask(0, 1.0, "")]
    assert tfaults.shed_pass(q, now=0.0, step=0, rf=None, slo=None,
                             obs=None) == (q, [], [])


@pytest.mark.parametrize("seed", range(4))
def test_coordinator_call_sequence_is_the_references(seed):
    """One scripted run of placements, crashes and re-dispatches through
    both coordinators, on views and arrivals from one seed: the same
    targets, survivors' destinations, counters, breaker states, events and
    counters of the bundle."""
    rng = np.random.default_rng(seed)
    R = 3
    plan_kw = dict(crashes=((0, 2, 3), (2, 5)),
                   transients=((1,), (4, 2), (6,)),
                   retry=dict(budget=int(rng.integers(1, 4)), seed=seed),
                   cooldown_placements=2, failure_threshold=2)
    sides = []
    for mod, rmod, omod in ((tfaults, trouter, tobs),
                            (jfaults, jrouter, jobs)):
        ob = omod.Observability()
        coord = mod.FaultCoordinator(
            _plan(mod, **dict(plan_kw)), R,
            rmod.Router(R, "rtlm", bulk_replicas=(2,),
                        bulk_classes=("batch",)), ob, kv_num_blocks=16)
        sides.append((coord, ob))
    placed = {0: [], 1: [], 2: []}
    for k in range(30):
        tid = k
        u = float(rng.uniform(0.0, 10.0))
        cls = str(rng.choice(["", "interactive", "batch"]))
        need = int(rng.integers(1, 20))
        got = [c.place(c.ledger_views(), task_id=tid, u=u, cls=cls,
                       arrival=0.1 * k, need=need) for c, _ in sides]
        assert got[0] == got[1]
        if got[0] is not None:
            placed[got[0]].append((tid, u, cls, need))
        if k in (8, 19):
            r = 0 if k == 8 else 2
            outs = []
            for c, _ in sides:
                assert c.should_crash(r, 10)
                c.note_crash(r)
                descs = [c.survivor(task_id=t, u=uu, cls=cc, arrival=0.0,
                                    need=nn, payload=t)
                         for t, uu, cc, nn in placed[r]]
                outs.append(c.redispatch(descs, from_replica=r))
            assert outs[0] == outs[1]
            placed[r] = []
        for r in range(R):
            assert sides[0][0].functional(r) == sides[1][0].functional(r)
            assert sides[0][0].health(r) == sides[1][0].health(r)
    (tc, tob), (jc, job) = sides
    assert tc.counters() == jc.counters()
    assert tc.failover_placements == jc.failover_placements
    assert tc.dead_letter_ids == jc.dead_letter_ids
    assert tc.breaker.state == jc.breaker.state
    assert (tc.placed_count, tc.u_sum) == (jc.placed_count, jc.u_sum)
    assert tob.trace.parity_events() == job.trace.parity_events()
    assert tob.metrics.counters() == job.metrics.counters()
    kinds = {e[0] for e in tob.trace.parity_events()}
    assert {"retry", "failover", "route"} <= kinds


# ---------------------------------------------------------------------------
# the engines against the simulator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    s = es.make_setup()
    s["ftexts"] = [s["texts"][i % 4] for i in range(24)]
    return s


def _pool(s, policy_name, R, plan_kw, caps, kw=PAGED, classes=None,
          slo=None, router="least_queue"):
    """The port's ReplicatedEngine and the simulator over one FaultPlan,
    each with its own bundle.  Returns (engine, result, sim, eobs, sobs)."""
    n = len(caps)
    texts = s["ftexts"][:n]
    eobs, sobs = _obs(tobs, slo), _obs(jobs, slo)
    eng = ReplicatedEngine(
        s["tp"], s["cfg"], es.port_policy(s, policy_name), s["tprof"],
        replicas=R, router=trouter.Router(R, router),
        faults=_plan(tfaults, **dict(plan_kw)), obs=eobs,
        input_bucket=es.BUCKET, max_new_tokens=es.MAX_NEW, eos_id=-1,
        device="cpu", **kw)
    res = eng.serve(es.requests(tengine, texts, caps, classes))
    sim_kw = dict(num_slots=kw["num_slots"], prompt_len=es.BUCKET)
    if kw["kv"] == "paged":
        sim_kw.update(kv_block_size=es.BS, kv_num_blocks=BLOCKS)
    sim = simulator.simulate_replicated(
        es.sim_tasks(s, texts, caps, classes),
        es.jax_policy(s, policy_name), R=R,
        router=jrouter.Router(R, router),
        faults=_plan(jfaults, **dict(plan_kw)), obs=sobs, **sim_kw)
    return eng, res, sim, eobs, sobs


def _pool_parity(res, sim, eobs, sobs, R):
    """Placements, fault outcomes, per-replica parity streams, the fault
    and route event subsequences and the counters, bit for bit."""
    assert res["placements"] == sim.placements
    assert res["placement_counts"] == sim.placement_counts()
    assert res["failover_placements"] == sim.failover_placements
    assert (res["retries"], res["failovers"], res["dead_lettered"],
            res["timed_out"], res["shed"]) \
        == (sim.retries, sim.failovers, sim.dead_lettered, sim.timed_out,
            sim.shed)
    for r in range(R):
        assert eobs.trace.parity_events(replica=r) \
            == sobs.trace.parity_events(replica=r), f"replica {r}"
        got = res["per_replica"][r]
        want = sim.replicas[r]
        assert res["completion_orders"][r] \
            == [t.task.task_id for t in want.tasks]
        if got is not None:
            assert got["crashed"] == want.crashed
    for kind in FAULT_KINDS + ("route",):
        ee = [e for e in eobs.trace.parity_events() if e[0] == kind]
        se = [e for e in sobs.trace.parity_events() if e[0] == kind]
        assert ee == se, kind
    assert eobs.metrics.counters() == sobs.metrics.counters()
    c = eobs.metrics.counters()
    for key in ("retries", "failovers", "dead_lettered", "timed_out",
                "shed"):
        assert c.get(f"faults.{key}", 0) == res[key], key


def _conserved(res, n):
    """Every task id is exactly one of completed, timed out, shed or
    dead-lettered, and no block is held."""
    ids = [tid for order in res["completion_orders"] for tid in order]
    for rr in res["per_replica"]:
        if rr is not None:
            ids += rr["timed_out_ids"] + rr["shed_ids"]
    assert len(ids) + res["dead_lettered"] == n
    assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
def test_crash_failover_parity(setup, R, policy_name):
    """The reference's crash case: least_queue pins task i to replica
    i % R; replica R-1 carries the long requests and crashes at its step 3
    with all three active; they fail over to the live replicas."""
    n = 3 * R
    caps = [es.MAX_NEW if i % R == R - 1 else 1 for i in range(n)]
    plan = dict(crashes=((R - 1, 3),), retry=dict(budget=3))
    eng, res, sim, eobs, sobs = _pool(setup, policy_name, R, plan, caps)
    assert res["per_replica"][R - 1]["crashed"]
    assert sim.replicas[R - 1].crashed
    assert len(res["failover_placements"]) == 3
    assert all(src == R - 1 and dst != R - 1
               for _, src, dst in res["failover_placements"])
    assert (res["retries"], res["failovers"], res["dead_lettered"]) \
        == (3, 3, 0)
    _pool_parity(res, sim, eobs, sobs, R)
    done = sorted(tid for order in res["completion_orders"]
                  for tid in order)
    assert done == list(range(n))
    assert sorted(res["per_replica"][R - 1]["survivor_ids"]) \
        == [R - 1, 2 * R - 1, 3 * R - 1]
    for e in eng.engines:
        e.allocator.check_no_leaks()
    assert list(res) == POOL_KEYS


def test_crash_failover_parity_contiguous(setup):
    """The same crash on the contiguous per-slot cache (no block model:
    the reservation need is 0 on both sides)."""
    R, n = 2, 6
    caps = [es.MAX_NEW if i % R == R - 1 else 1 for i in range(n)]
    plan = dict(crashes=((R - 1, 3),), retry=dict(budget=3))
    _, res, sim, eobs, sobs = _pool(setup, "fifo", R, plan, caps,
                                    kw=CONTIGUOUS)
    assert res["per_replica"][R - 1]["crashed"]
    assert (res["retries"], res["failovers"]) == (3, 3)
    _pool_parity(res, sim, eobs, sobs, R)
    _conserved(res, n)


def test_transient_dispatch_fault_parity(setup):
    """The pool's second placement fails once: task 1 retries onto the
    other replica."""
    plan = dict(transients=((1,),), retry=dict(budget=2))
    _, res, sim, eobs, sobs = _pool(setup, "fifo", 2, plan, [1, 1, 1, 1])
    assert res["placements"] == sim.placements == [0, 0, 1, 1]
    assert res["retries"] == 1 and res["dead_lettered"] == 0
    _pool_parity(res, sim, eobs, sobs, 2)


def test_breaker_recovery_replica_up_parity(setup):
    """A crash with recovery after one placement: the breaker half-opens,
    the probe succeeds (``replica_up``) and failover load returns to the
    recovered replica."""
    caps = [es.MAX_NEW if i % 2 else 1 for i in range(6)]
    plan = dict(crashes=((1, 3, 1),), retry=dict(budget=3),
                cooldown_placements=1)
    eng, res, sim, eobs, sobs = _pool(setup, "fifo", 2, plan, caps)
    assert [dst for _, _, dst in res["failover_placements"]] == [0, 1, 1]
    assert sum(e[0] == "replica_up"
               for e in eobs.trace.parity_events()) == 1
    _pool_parity(res, sim, eobs, sobs, 2)
    assert sorted(tid for order in res["completion_orders"]
                  for tid in order) == list(range(6))
    # the recovered replica served a second round, from its crash step on
    rr = res["per_replica"][1]
    assert rr["crashed"] and rr["final_step"] > 3
    for e in eng.engines:
        e.allocator.check_no_leaks()


def test_all_replicas_down_parity(setup):
    """Both replicas crash at step 1: the engine's round-based failover
    and the simulator's interleaved one reach the same retry, failover and
    dead-letter totals (the reference's claim: the per-replica streams of
    the two drivers differ here), everything dead-letters, and neither
    hangs."""
    n = 6
    plan = dict(crashes=((0, 1), (1, 1)), retry=dict(budget=3))
    eng, res, sim, eobs, sobs = _pool(setup, "fifo", 2, plan,
                                      [es.MAX_NEW] * n)
    assert res["dead_lettered"] == sim.dead_lettered == n
    assert (res["retries"], res["failovers"]) \
        == (sim.retries, sim.failovers)
    c = eobs.metrics.counters()
    assert c["faults.dead_lettered"] == n
    assert c["faults.replica_down"] == 2
    assert c["faults.retries"] == res["retries"]
    assert c["faults.failovers"] == res["failovers"]
    assert not any(res["completion_orders"])
    _conserved(res, n)
    for e in eng.engines:
        e.allocator.check_no_leaks()




def _obs(mod, slo):
    """A bundle of ``mod`` with SLO targets ``{class: SLOSpec kwargs}``
    (none with ``slo=None``)."""
    return mod.Observability(slo=slo and {k: mod.SLOSpec(**v)
                                          for k, v in slo.items()})


def _single(s, policy_name, rf_kw, caps, classes, slo, **kw):
    """A faulted single engine of the port and ``simulate_continuous``
    under one ``ReplicaFaults``.  Returns (engine, result, sim, eobs,
    sobs)."""
    kw = {**PAGED, **kw}
    texts = s["ftexts"][:len(caps)]
    eobs, sobs = _obs(tobs, slo), _obs(jobs, slo)
    rf_t = _rf(tfaults, rf_kw)
    eng = es.port_engine(s, policy_name, faults=rf_t, obs=eobs, **kw)
    res = eng.serve(es.requests(tengine, texts, caps, classes))
    sim = simulator.simulate_continuous(
        es.sim_tasks(s, texts, caps, classes), es.jax_policy(s, policy_name),
        faults=_rf(jfaults, rf_kw), obs=sobs, num_slots=kw["num_slots"],
        kv_block_size=es.BS, kv_num_blocks=BLOCKS, prompt_len=es.BUCKET)
    return eng, res, sim, eobs, sobs


def _rf(mod, kw):
    """A ``ReplicaFaults`` of ``mod`` from plain values (slowdowns as
    tuples, the shed policy as a dict)."""
    kw = dict(kw)
    if "shed" in kw:
        kw["shed"] = mod.ShedPolicy(**kw["shed"])
    kw["slowdowns"] = tuple(mod.SlowFault(*x)
                            for x in kw.get("slowdowns", ()))
    return mod.ReplicaFaults(**kw)


def test_deadline_timeout_parity(setup):
    """Judgment-invariant deadlines (-1.0 doomed at the first check, no
    target never): every doomed request times out before admission."""
    classes = ["doomed" if i % 2 else "lucky" for i in range(6)]
    slo = {"doomed": dict(e2e_s=-1.0), "lucky": {}}
    _, res, sim, eobs, sobs = _single(setup, "fifo", dict(deadlines=True),
                                      [2] * 6, classes, slo)
    assert res["timed_out"] == sim.timed_out == 3
    assert res["timed_out_ids"] == [1, 3, 5]
    assert res["shed"] == sim.shed == 0
    assert eobs.trace.parity_events() == sobs.trace.parity_events()
    assert eobs.metrics.counters() == sobs.metrics.counters()
    assert eobs.slo.parity_counters() == sobs.slo.parity_counters()
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]


def test_uncertainty_shed_parity(setup):
    """Queue pressure on a one-slot engine: the bulk class first, then
    the highest-``u`` predicted deadline-missers."""
    classes = ["rush", "batch", "rush", "batch", "rush", "rush"]
    slo = {"rush": dict(e2e_s=-1.0), "batch": {}}
    rf = dict(shed=dict(queue_depth=2, bulk_classes=("batch",)))
    _, res, sim, eobs, sobs = _single(setup, "fifo", rf, [1] * 6, classes,
                                      slo, num_slots=1)
    assert res["timed_out"] == sim.timed_out == 0
    assert res["shed"] == sim.shed == 4
    assert set(res["shed_ids"]) >= {1, 3}
    assert eobs.trace.parity_events() == sobs.trace.parity_events()
    assert eobs.metrics.counters() == sobs.metrics.counters()
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]


def test_slowdown_stretches_only_the_clock(setup):
    """A straggler fault over the whole serve changes no decision: the
    simulator's parity stream, and an unslowed serve's schedule and
    tokens."""
    rf = dict(slowdowns=((0, 0, 10 ** 6, 4.0),))
    _, slow, sim, eobs, sobs = _single(setup, "fifo", rf, es.CAPS, None,
                                       None)
    _, base, _, _, _ = _single(setup, "fifo", {}, es.CAPS, None, None)
    assert slow["completion_order"] == base["completion_order"] \
        == [t.task.task_id for t in sim.tasks]
    assert slow["decode_dispatch_trace"] == base["decode_dispatch_trace"]
    assert es.tokens(slow) == es.tokens(base)
    assert eobs.trace.parity_events() == sobs.trace.parity_events()
    assert eobs.metrics.counters() == sobs.metrics.counters()


def test_unfaulted_runs_carry_no_fault_keys(setup):
    """With no plan no fault key, fault event kind or faults.* counter
    appears, in a single engine or a pool."""
    eobs, sobs = tobs.Observability(), jobs.Observability()
    eng = es.port_engine(setup, "fifo", obs=eobs, **PAGED)
    res = eng.serve(es.requests(tengine, setup["ftexts"][:4], [2] * 4))
    sim = simulator.simulate_continuous(
        es.sim_tasks(setup, setup["ftexts"][:4], [2] * 4),
        es.jax_policy(setup, "fifo"), obs=sobs, num_slots=es.SLOTS,
        kv_block_size=es.BS, kv_num_blocks=BLOCKS, prompt_len=es.BUCKET)
    for key in ("timed_out", "shed", "timed_out_ids", "shed_ids",
                "crashed", "final_step", "survivor_ids"):
        assert key not in res
    for ob in (eobs, sobs):
        assert not any(k.startswith("faults.")
                       for k in ob.metrics.counters())
        assert not any(e[0] in FAULT_KINDS
                       for e in ob.trace.parity_events())
    assert eobs.trace.parity_events() == sobs.trace.parity_events()
    pool = ReplicatedEngine(
        setup["tp"], setup["cfg"], es.port_policy(setup, "fifo"),
        setup["tprof"], replicas=2, input_bucket=es.BUCKET,
        max_new_tokens=es.MAX_NEW, eos_id=-1, device="cpu", **PAGED)
    pres = pool.serve(es.requests(tengine, setup["ftexts"][:4], [2] * 4))
    assert "retries" not in pres and "failover_placements" not in pres
    for rr in pres["per_replica"]:
        assert "crashed" not in rr


@pytest.mark.parametrize("kw,match", [
    (dict(mode="batch"), "continuous"),
    (dict(mode="continuous", kv="paged", kv_block_size=es.BS,
          prefill="chunked"), "stall"),
], ids=["batch", "chunked"])
def test_faults_require_the_stall_loop(setup, kw, match):
    with pytest.raises(ValueError, match=match) as want:
        es.jax_engine(setup, "fifo", faults=jfaults.ReplicaFaults(), **kw)
    with pytest.raises(ValueError, match=match) as got:
        es.port_engine(setup, "fifo", faults=tfaults.ReplicaFaults(), **kw)
    assert str(got.value) == str(want.value)


def test_replicated_engine_validates_the_plan(setup):
    with pytest.raises(ValueError, match="out of range"):
        ReplicatedEngine(
            setup["tp"], setup["cfg"], es.port_policy(setup, "fifo"),
            setup["tprof"], replicas=2, device="cpu",
            faults=tfaults.FaultPlan(crashes=(tfaults.CrashFault(7, 1),)),
            **PAGED)


# ---------------------------------------------------------------------------
# against the JAX engines
# ---------------------------------------------------------------------------


def _jax_profile(s):
    return dataclasses.replace(s["jprof"],
                               predictor=es.PortScores(s["tprof"].predictor))


def _jax_pool(s, policy_name, R, plan_kw, caps, classes=None, slo=None):
    """The JAX ``ReplicatedEngine`` (scoring with the port's m_theta) over
    the same requests and plan.  Returns (result, bundle)."""
    ob = _obs(jobs, slo)
    eng = jreplica.ReplicatedEngine(
        s["jp"], s["cfg"], es.jax_policy(s, policy_name), _jax_profile(s),
        replicas=R, router=jrouter.Router(R, "least_queue"),
        faults=_plan(jfaults, **dict(plan_kw)), obs=ob,
        input_bucket=es.BUCKET, max_new_tokens=es.MAX_NEW, eos_id=-1,
        **PAGED)
    return eng.serve(es.requests(jengine, s["ftexts"][:len(caps)], caps,
                                 classes)), ob


def _same_pool(res, want, eobs, job, R):
    """A port pool's result and bundle against the JAX pool's: the pool
    keys, and per replica the parity stream, tokens and fault fields."""
    assert list(res) == list(want)
    for key in ("placements", "failover_placements", "completion_orders",
                "retries", "failovers", "dead_lettered", "timed_out",
                "shed", "placement_counts"):
        assert res[key] == want[key], key
    for r in range(R):
        assert eobs.trace.parity_events(replica=r) \
            == job.trace.parity_events(replica=r), f"replica {r}"
        got, exp = res["per_replica"][r], want["per_replica"][r]
        assert es.tokens(got) == es.tokens(exp)
        for key in ("crashed", "final_step", "survivor_ids",
                    "timed_out_ids", "shed_ids", "n_tasks",
                    "decode_dispatch_trace", "prefill_dispatch_trace"):
            assert got[key] == exp[key], (r, key)
    assert eobs.trace.parity_events() == job.trace.parity_events()
    assert eobs.metrics.counters() == job.metrics.counters()


def test_crash_failover_tokens_match_jax_pool(setup):
    """R = 2, fifo, replica 1 crashing at step 3 with its three requests
    active: the JAX pool gives the same placements, failovers, per-replica
    streams, completion orders and tokens."""
    R, n = 2, 6
    caps = [es.MAX_NEW if i % R == R - 1 else 2 for i in range(n)]
    plan = dict(crashes=((R - 1, 3),), retry=dict(budget=3))
    _, res, _, eobs, _ = _pool(setup, "fifo", R, plan, caps)
    want, job = _jax_pool(setup, "fifo", R, plan, caps)
    assert res["failovers"] == 3
    _same_pool(res, want, eobs, job, R)


def test_every_mechanism_in_one_pool_matches_jax_pool(setup):
    """A four-replica pool under one plan that crashes a replica with
    active requests, slows another, fails a dispatch, times out and sheds
    (chip_smoke phase 7b's plan at smoke size).  The failover targets are
    busy when the crash lands, where the simulator's interleaved delivery
    and the engines' rounds part ways, so the oracle is the JAX pool: the
    same placements, fault outcomes, per-replica streams, counters, SLO
    counts and tokens, and every id accounted for."""
    R, n = 4, 24
    caps = [es.MAX_NEW if i % R == 3 else es.CAPS[i % len(es.CAPS)]
            for i in range(n)]
    classes = [("doomed", "interactive", "batch")[i % 3] for i in range(n)]
    slo = {"interactive": {}, "batch": {}, "doomed": dict(e2e_s=-1.0)}
    plan = dict(crashes=((3, 2),), slowdowns=((2, 0, 16, 2.0),),
                transients=((5,),), retry=dict(budget=3),
                shed=dict(queue_depth=2, bulk_classes=("batch",)),
                deadlines=True)
    eng, res, _, eobs, _ = _pool(setup, "rt-lm", R, plan, caps,
                                 classes=classes, slo=slo)
    want, job = _jax_pool(setup, "rt-lm", R, plan, caps, classes, slo)
    _same_pool(res, want, eobs, job, R)
    assert eobs.slo.parity_counters() == job.slo.parity_counters()
    rr = res["per_replica"][3]
    assert rr["crashed"] and rr["survivor_ids"]
    assert res["retries"] >= 2 and res["failovers"] >= 1
    assert res["timed_out"] > 0 and res["shed"] > 0
    _conserved(res, n)
    for e in eng.engines:
        e.allocator.check_no_leaks()


@pytest.mark.parametrize("rf_kw,classes", [
    (dict(crash_at_step=0), None),
    (dict(deadlines=True), ["doomed"] * 3),
], ids=["crashed-at-0", "all-timed-out"])
def test_a_serve_that_completes_nothing_reports_zeros(setup, rf_kw,
                                                      classes):
    """No completed request: every aggregate is zero and finite, the same
    result keys and values as the JAX engine's."""
    slo = {"doomed": dict(e2e_s=-1.0)}
    texts, caps = setup["ftexts"][:3], [2] * 3
    eobs, job = _obs(tobs, slo), _obs(jobs, slo)
    eng = es.port_engine(setup, "fifo", faults=_rf(tfaults, rf_kw),
                         obs=eobs, **PAGED)
    res = eng.serve(es.requests(tengine, texts, caps, classes))
    jeng = es.jax_engine(setup, "fifo", faults=_rf(jfaults, rf_kw),
                         obs=job, **PAGED)
    jeng.profile = _jax_profile(setup)
    want = jeng.serve(es.requests(jengine, texts, caps, classes))
    assert res["completion_order"] == [] and res["tasks"] == []
    for key in ("mean_response_s", "max_response_s", "kv_util_peak",
                "kv_util_mean", "ttft_p50", "ttft_p90", "ttft_p99",
                "itl_p50", "itl_p90", "itl_p99", "queue_wait_p50",
                "queue_wait_p90", "queue_wait_p99"):
        assert res[key] == 0.0 == want[key], key
    assert all(math.isfinite(v) for v in res.values()
               if isinstance(v, float))
    assert set(want) <= set(res)
    for key in ("timed_out", "shed", "timed_out_ids", "shed_ids",
                "crashed", "final_step", "survivor_ids", "n_tasks",
                "throughput_per_min"):
        assert res[key] == want[key], key
    assert eobs.trace.parity_events() == job.trace.parity_events()
    eng.allocator.check_no_leaks()


# ---------------------------------------------------------------------------
# completion worker lifecycle
# ---------------------------------------------------------------------------


class _Poison:
    """A submitted result whose host conversion raises, as a readback from
    a failing device would."""

    device = torch.device("cpu")

    def detach(self):
        return self

    def clone(self):
        return self

    def numpy(self):
        raise RuntimeError("device readback poisoned")


def test_completion_worker_raises_at_collect_and_survives():
    w = tpipeline.CompletionWorker()
    w.submit(torch.zeros(3), 0.0)
    assert w.collect()[0].shape == (3,)
    w.submit(_Poison(), 0.0)
    with pytest.raises(RuntimeError, match="poisoned"):
        w.collect()
    w.submit(torch.ones(2), 0.0)            # the thread survived it
    assert w.collect()[0].tolist() == [1.0, 1.0]
    w.close()
    assert not w._thread.is_alive()
    w.close()                               # idempotent
    with tpipeline.CompletionWorker() as cw:
        cw.submit(torch.zeros(1), 0.0)
        cw.collect()
    assert not cw._thread.is_alive()


def test_poisoned_decode_unwinds_serve(setup, monkeypatch):
    """A decode window's readback failure surfaces as itself and the
    worker is torn down."""
    eng = es.port_engine(setup, "fifo", **PAGED)

    def poisoned_collect(self):
        raise RuntimeError("decode window poisoned")

    monkeypatch.setattr(tpipeline.CompletionWorker, "collect",
                        poisoned_collect)
    with pytest.raises(RuntimeError, match="decode window poisoned"):
        eng.serve(es.requests(tengine, setup["ftexts"][:2], [2, 2]))
    assert eng._worker is None
