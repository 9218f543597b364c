"""PyTorch port: the router, the replica device groups and the replicated
engine (``repro_torch.serving.router``, ``repro_torch.launch.mesh``,
``repro_torch.serving.replica``) against the reference.

  * the router copy — on seeded random ``ReplicaView``s, every policy
    (``round_robin``, ``least_queue``, ``rtlm``) gives the reference's
    ``RouteDecision`` with a bit-equal score, through bulk slices, health
    gating, the admissibility gate, ``NoEligibleReplica`` and the
    independent round-robin cursors; the same validation errors;
  * ``replica_groups`` — the reference's groups on lists of devices, the
    visible cards by default, and a refusal without a card;
  * ``ReplicatedEngine`` against ``simulate_replicated`` (the reference's
    tests/test_router.py grid): R in {1, 2, 4} x {fifo, rt-lm}, an rtlm
    router with a bulk slice — placements, route events, per-replica
    parity event streams, completion orders, counters and SLO parity
    counts bit for bit; R = 1 byte-identical to a single engine; the
    validation errors.

The simulator is fed the port's ``u`` (``tests/torch_engine_setup.py``),
so the rtlm scores compare exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import simulator  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.serving.replica import ReplicatedEngine  # noqa: E402

BLOCKS = 64                       # per-replica pool (generous: no rejects)
CLS = ["interactive", "batch"] * (len(es.CAPS) // 2)
HEALTH = ("closed", "half_open", "open")


# ---------------------------------------------------------------------------
# the router copy against the reference
# ---------------------------------------------------------------------------


def _router_config(rng):
    R = int(rng.integers(1, 6))
    policy = trouter.ROUTER_POLICIES[int(rng.integers(0, 3))]
    bulk = ()
    if R > 1 and rng.random() < 0.6:
        k = int(rng.integers(1, R))
        bulk = tuple(int(b) for b in rng.choice(R, size=k, replace=False))
    u_scale = float(rng.choice([1.0, 8.0, 30.0]))
    return R, policy, dict(bulk_replicas=bulk,
                           bulk_classes=("batch",) if bulk else (),
                           u_scale=u_scale)


def _views(mod, rng, R, bulk):
    out = []
    for r in range(R):
        num = int(rng.choice([0, 8, 16, 64]))
        out.append(mod.ReplicaView(
            replica=r, queued=int(rng.integers(0, 6)),
            active=int(rng.integers(0, 4)),
            free_blocks=int(rng.integers(0, num + 1)) if num else 0,
            num_blocks=num, u_load=float(rng.uniform(0.0, 40.0)),
            is_bulk=r in bulk,
            health=HEALTH[int(rng.choice(3, p=[0.7, 0.15, 0.15]))]))
    return out


def _decide(router, views, **kw):
    try:
        d = router.place(views, **kw)
    except ValueError as exc:
        return (type(exc).__name__, str(exc))
    return (d.replica, d.score, d.policy)


@pytest.mark.parametrize("seed", range(8))
def test_router_copy_places_as_the_reference(seed):
    """A run of placements per router (so the round-robin cursors carry
    over), on random views with random health, reservation needs and
    classes: the port decides and scores as the reference does, and both
    refuse the same arrivals with the same message."""
    rng = np.random.default_rng(seed)
    refused = placed = 0
    for _ in range(12):
        R, policy, kw = _router_config(rng)
        tr = trouter.Router(R, policy, **kw)
        jr = jrouter.Router(R, policy, **kw)
        assert tr.eligible("batch") == jr.eligible("batch")
        assert tr.eligible("interactive") == jr.eligible("interactive")
        for _ in range(16):
            state = rng.bit_generator.state
            tv = _views(trouter, rng, R, tr.bulk_replicas)
            rng.bit_generator.state = state
            jv = _views(jrouter, rng, R, jr.bulk_replicas)
            arrival = dict(u=float(rng.uniform(0.0, 20.0)),
                           cls=str(rng.choice(["", "interactive",
                                               "batch"])),
                           need=int(rng.integers(0, 20)))
            got = _decide(tr, tv, **arrival)
            want = _decide(jr, jv, **arrival)
            assert got == want, (R, policy, kw, arrival)
            if isinstance(got[0], str):
                assert got[0] == "NoEligibleReplica"
                refused += 1
            else:
                placed += 1
                assert tr.score(tv[got[0]], u=arrival["u"],
                                need=arrival["need"]) \
                    == jr.score(jv[got[0]], u=arrival["u"],
                                need=arrival["need"])
        assert tr._rr_cursor == jr._rr_cursor
    assert refused > 0 and placed > 0


def test_round_robin_cursors_are_independent_per_group():
    """The reference's bulk-slice cursor case, on both copies."""
    out = []
    for mod in (trouter, jrouter):
        router = mod.Router(4, "round_robin", bulk_replicas=(2, 3),
                            bulk_classes=("batch",))
        v = [mod.ReplicaView(replica=r, is_bulk=r in (2, 3))
             for r in range(4)]
        seq = [router.place(v, cls=c).replica
               for c in ("interactive", "batch") * 4]
        v[0] = dataclasses.replace(v[0], health="open")
        seq += [router.place(v, cls="interactive").replica
                for _ in range(3)]
        out.append(seq)
    assert out[0] == out[1]
    assert out[0][:8] == [0, 2, 1, 3, 0, 2, 1, 3]
    assert out[0][8:] == [1, 1, 1]


def test_no_eligible_replica_is_a_value_error():
    assert issubclass(trouter.NoEligibleReplica, ValueError)
    router = trouter.Router(2, "least_queue")
    v = [trouter.ReplicaView(replica=r, free_blocks=4, num_blocks=4)
         for r in range(2)]
    with pytest.raises(trouter.NoEligibleReplica, match="no eligible"):
        router.place(v, need=10)
    v = [dataclasses.replace(x, health="open") for x in v]
    with pytest.raises(trouter.NoEligibleReplica):
        router.place(v)


@pytest.mark.parametrize("args,kw", [
    ((0,), {}),
    ((2, "nope"), {}),
    ((2,), dict(bulk_replicas=(5,))),
    ((2,), dict(bulk_replicas=(0, 1))),
    ((2,), dict(u_scale=0.0)),
], ids=["R", "policy", "bulk-range", "bulk-all", "u_scale"])
def test_router_validation_matches_the_reference(args, kw):
    with pytest.raises(ValueError) as want:
        jrouter.Router(*args, **kw)
    with pytest.raises(ValueError) as got:
        trouter.Router(*args, **kw)
    assert str(got.value) == str(want.value)


def test_place_view_count_error_matches_the_reference():
    msgs = []
    for mod in (trouter, jrouter):
        with pytest.raises(ValueError) as exc:
            mod.Router(3).place([mod.ReplicaView(replica=0)])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert trouter.ROUTER_POLICIES == jrouter.ROUTER_POLICIES


# ---------------------------------------------------------------------------
# replica device groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R,n", [(1, 1), (2, 8), (3, 8), (4, 1), (4, 3),
                                 (4, 4), (5, 2)])
def test_replica_groups_match_the_reference(R, n):
    names = [f"d{i}" for i in range(n)]
    assert tmesh.replica_groups(R, devices=names) \
        == jmesh.replica_groups(R, devices=names)
    cpu = [torch.device("cpu")] * n
    groups = tmesh.replica_groups(R, devices=cpu)
    assert len(groups) == R and all(g and all(d.type == "cpu" for d in g)
                                    for g in groups)


def test_replica_groups_default_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.replica_groups(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmesh.replica_groups(2) == [
        [torch.device("cuda", 0), torch.device("cuda", 1)],
        [torch.device("cuda", 2), torch.device("cuda", 3)]]
    assert tmesh.replica_groups(8) == [[torch.device("cuda", r % 4)]
                                       for r in range(8)]
    with pytest.raises(ValueError, match="R must be"):
        tmesh.replica_groups(0, devices=["d0"])
    with pytest.raises(RuntimeError, match="no devices"):
        tmesh.replica_groups(1, devices=[])


# ---------------------------------------------------------------------------
# ReplicatedEngine against simulate_replicated
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    s = es.make_setup()
    s["rtexts"] = [s["texts"][i % 4] for i in range(len(es.CAPS))]
    return s


def make_obs(mod):
    """The reference's judgment-invariant targets: an empty spec always
    attains, -1.0 never, so the SLO counts compare exactly."""
    return mod.Observability(slo={
        "interactive": mod.SLOSpec(),
        "batch": mod.SLOSpec(ttft_s=-1.0, itl_s=-1.0, e2e_s=-1.0,
                             queue_wait_s=-1.0)})


def router_for(mod, R):
    """An rtlm router (float scores in the route events), with the last
    replica the bulk slice when R > 1."""
    kw = dict(bulk_replicas=(R - 1,), bulk_classes=("batch",)) \
        if R > 1 else {}
    return mod.Router(R, "rtlm", **kw)


def engine_kw():
    return dict(input_bucket=es.BUCKET, max_new_tokens=es.MAX_NEW,
                mode="continuous", eos_id=-1, kv="paged",
                kv_block_size=es.BS, num_slots=es.SLOTS,
                kv_num_blocks=BLOCKS, device="cpu")


def single_kw():
    """``engine_kw`` for ``es.port_engine``, which sets the rest."""
    return dict(mode="continuous", kv="paged", kv_block_size=es.BS,
                num_slots=es.SLOTS, kv_num_blocks=BLOCKS)


@pytest.fixture(scope="module")
def replicated_run(setup):
    """Memoized replicated serves: (R, policy) -> (engine, result, obs)."""
    memo = {}

    def _run(R, policy_name):
        if (R, policy_name) not in memo:
            ob = make_obs(tobs)
            eng = ReplicatedEngine(
                setup["tp"], setup["cfg"], es.port_policy(setup, policy_name),
                setup["tprof"], replicas=R, router=router_for(trouter, R),
                obs=ob, **engine_kw())
            res = eng.serve(es.requests(tengine, setup["rtexts"],
                                        classes=CLS))
            memo[(R, policy_name)] = (eng, res, ob)
        return memo[(R, policy_name)]

    return _run


def sim_replicated(s, R, policy_name, ob):
    return simulator.simulate_replicated(
        es.sim_tasks(s, s["rtexts"], classes=CLS),
        es.jax_policy(s, policy_name), R=R, router=router_for(jrouter, R),
        obs=ob, num_slots=es.SLOTS, kv_block_size=es.BS,
        kv_num_blocks=BLOCKS, prompt_len=es.BUCKET)


@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
def test_replicated_engine_vs_sim(setup, replicated_run, R, policy_name):
    eng, res, eobs = replicated_run(R, policy_name)
    sobs = make_obs(jobs)
    sim = sim_replicated(setup, R, policy_name, sobs)
    assert res["placements"] == sim.placements
    assert res["placement_counts"] == sim.placement_counts()
    if R > 1:
        for i, cls in enumerate(CLS):
            assert (res["placements"][i] == R - 1) == (cls == "batch")
    eroutes = [e for e in eobs.trace.parity_events() if e[0] == "route"]
    sroutes = [e for e in sobs.trace.parity_events() if e[0] == "route"]
    assert eroutes == sroutes
    assert len(eroutes) == (len(es.CAPS) if R > 1 else 0)
    for r in range(R):
        assert eobs.trace.parity_events(replica=r) \
            == sobs.trace.parity_events(replica=r), f"replica {r}"
        assert res["completion_orders"][r] \
            == [t.task.task_id for t in sim.replicas[r].tasks]
        eng.engines[r].allocator.check_no_leaks()
    assert eobs.metrics.counters() == sobs.metrics.counters()
    assert eobs.slo.parity_counters() == sobs.slo.parity_counters()
    assert res["rejected_for_memory"] == sum(
        r.kv_rejected for r in sim.replicas)
    assert res["fallback_events"] == 0
    assert list(res) == ["mode", "replicas", "router_policy", "n_tasks",
                         "placements", "placement_counts", "per_replica",
                         "completion_orders", "rejected_for_memory",
                         "fallback_events"]
    assert eng.replica_devices() == [[torch.device("cpu")]] * R


def test_replicas_serve_their_groups_as_single_engines(setup,
                                                      replicated_run):
    """The R = 4 pool's replicas share nothing but the parameters, the
    policy and the bundle: each one's tokens and schedule are a fresh
    single engine's serve of its group."""
    eng, res, _ = replicated_run(4, "rt-lm")
    reqs = es.requests(tengine, setup["rtexts"], classes=CLS)
    for r in range(4):
        group = [q for q, p in zip(reqs, res["placements"]) if p == r]
        one = es.port_engine(setup, "rt-lm", **single_kw())
        want = one.serve(group)
        got = res["per_replica"][r]
        assert es.tokens(got) == es.tokens(want)
        for f in ("completion_order", "decode_dispatch_trace",
                  "prefill_dispatch_trace", "budget_trace"):
            assert got[f] == want[f], (r, f)


def test_r1_replicated_is_the_single_engine(setup, replicated_run):
    """R = 1 is the single engine's stream: the same events and counters,
    no route events, no replica fields, no r0.* mirrors."""
    _, rep_res, rep_obs = replicated_run(1, "rt-lm")
    ob = make_obs(tobs)
    eng = es.port_engine(setup, "rt-lm", obs=ob, **single_kw())
    res = eng.serve(es.requests(tengine, setup["rtexts"], classes=CLS))
    assert ob.trace.parity_events() == rep_obs.trace.parity_events()
    assert not any(e[0] == "route" for e in rep_obs.trace.parity_events())
    assert not any("replica" in dict(e[3])
                   for e in rep_obs.trace.parity_events())
    assert ob.metrics.counters() == rep_obs.metrics.counters()
    assert not any(k.startswith("r0.") for k in rep_obs.metrics.counters())
    assert res["completion_order"] == rep_res["completion_orders"][0]
    assert es.tokens(res) == es.tokens(rep_res["per_replica"][0])


def test_replicated_engine_validation(setup):
    policy = es.port_policy(setup, "fifo")
    with pytest.raises(ValueError, match="replicas must be"):
        ReplicatedEngine(setup["tp"], setup["cfg"], policy, setup["tprof"],
                         replicas=0, device="cpu")
    with pytest.raises(ValueError, match="router expects"):
        ReplicatedEngine(setup["tp"], setup["cfg"], policy, setup["tprof"],
                         replicas=2, router=trouter.Router(3), device="cpu")
    eng = ReplicatedEngine(setup["tp"], setup["cfg"], policy,
                           setup["tprof"], replicas=3, device="cpu")
    assert eng.router.policy == "round_robin" and eng.router.R == 3
    assert len({id(e) for e in eng.engines}) == 3
    assert all(e.params is setup["tp"] and e.policy is policy
               for e in eng.engines)
