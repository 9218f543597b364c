"""The port's discrete-event simulator (``repro_torch.core.simulator``, a
copy of the framework-free reference) against ``repro.core.simulator``,
bit for bit, on the same seeded workloads.

Each side runs on its own package's copies (SimTask, personas, policies,
the allocator, the prefix cache, the chunk packer, the metrics, the
router and the fault machinery), so a difference anywhere in those copies
shows here too.  Compared: every task's start, finish, lane, priority and
completion order; every field of the result but the task list; the
``summary()``; and, where an ``Observability`` bundle rides along, its
lifecycle events (slots are recorded only there, in the admit events),
counters, SLO counters and calibration ledger.

Entry R1 of ROADMAP Queue 3 (continuous batching can finish a homogeneous
FIFO load later than batch mode) is the reference's behaviour, and the
port reproduces its falsifying example number for number.
"""

import dataclasses
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import personas as jpersonas  # noqa: E402
from repro.core import priority as jprio  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import personas as tpersonas  # noqa: E402
from repro_torch.core import priority as tprio  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402

REF = types.SimpleNamespace(sim=jsim, prio=jprio, sched=jsched,
                            personas=jpersonas, obs=jobs, faults=jfaults,
                            router=jrouter)
PORT = types.SimpleNamespace(sim=tsim, prio=tprio, sched=tsched,
                             personas=tpersonas, obs=tobs, faults=tfaults,
                             router=trouter)
SIDES = (REF, PORT)

ALL_POLICIES = ["fifo", "hpf", "luf", "muf", "up", "up+c", "rt-lm"]
CLASSES = ("interactive", "batch")


# ---------------------------------------------------------------------------
# workloads, built once from numpy and handed to each side as its own types
# ---------------------------------------------------------------------------


def random_workload(seed, n=40):
    """tests/test_simulator.py's workload: u uniform in [0.5, 60),
    Poisson arrivals of mean gap 0.3 s, deadline r + 4."""
    rng = np.random.default_rng(seed)
    us = rng.uniform(0.5, 60.0, size=n)
    arrivals = np.cumsum(rng.exponential(0.3, n))
    return [dict(u=float(u), r=float(r), d=float(r) + 4.0, input_len=5.0,
                 true_out_len=max(1, int(u)), task_id=i,
                 traffic_class="")
            for i, (u, r) in enumerate(zip(us, arrivals))]


def serving_workload(seed, n=24, max_out=7, prompt_len=8, spread=0.05):
    """A serving trace: traffic classes, u and lengths from a seed, a
    shared prompt prefix on every third request (for the prefix cache)."""
    rng = np.random.default_rng(seed)
    us = rng.uniform(0.5, 12.0, size=n)
    outs = rng.integers(1, max_out + 1, size=n)
    arrivals = np.cumsum(rng.exponential(spread, n))
    shared = [int(x) for x in rng.integers(0, 1000, size=prompt_len)]
    rows = []
    for i in range(n):
        own = [int(x) for x in rng.integers(0, 1000, size=prompt_len)]
        toks = shared[:prompt_len - 1] + own[:1] if i % 3 == 0 else own
        rows.append(dict(u=float(us[i]), r=float(arrivals[i]),
                         d=float(arrivals[i]) + 1.5,
                         input_len=float(prompt_len),
                         true_out_len=int(outs[i]), task_id=i,
                         traffic_class=CLASSES[i % 2],
                         tokens=tuple(toks)))
    return rows


def tasks_for(side, rows):
    return [side.prio.SimTask(
        task=types.SimpleNamespace(task_id=w["task_id"],
                                   traffic_class=w["traffic_class"],
                                   tokens=w.get("tokens", ())),
        u=w["u"], r=w["r"], d=w["d"], input_len=w["input_len"],
        true_out_len=w["true_out_len"]) for w in rows]


def prompt_tokens(task):
    return task.task.tokens


def make_obs(side):
    """The full bundle: trace, metrics, SLO monitor over two classes (one
    with targets every request misses), calibration ledger, a health
    snapshot every two decode steps."""
    targets = {"interactive": side.obs.SLOSpec(ttft_s=0.2, e2e_s=1.0),
               "batch": side.obs.SLOSpec(ttft_s=-1.0, itl_s=-1.0,
                                         e2e_s=-1.0, queue_wait_s=-1.0)}
    return side.obs.Observability(slo=targets, calibration=True,
                                  snapshot_every_steps=2)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def plain(x):
    """A result value as nested builtins; NaN as a string so that two NaNs
    compare equal and every other float compares bit for bit."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return plain(x.item())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def schedule(tasks) -> list:
    return [(t.task.task_id, t.start, t.finish, t.lane, t.u, t.p)
            for t in tasks]


def result_view(res) -> dict:
    """Every field of a SimResult (or ReplicatedSimResult) but ``tasks``,
    the tasks' schedule in completion order, and the summary."""
    out = {f.name: plain(getattr(res, f.name))
           for f in dataclasses.fields(res)
           if f.name not in ("tasks", "replicas")}
    if hasattr(res, "replicas"):
        out["replicas"] = [result_view(r) for r in res.replicas]
    out["schedule"] = schedule(res.tasks)
    out["summary"] = plain(res.summary()) if res.tasks else None
    return out


def obs_view(ob) -> dict:
    return {"events": plain(ob.trace.parity_events()),
            "counters": ob.metrics.counters(),
            "slo": ob.slo.parity_counters(),
            "attainment": plain(ob.slo.attainment()),
            "calibration": plain(ob.calibration.summary()),
            "health": plain(list(ob.health_trace))}


def assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# run_policy: 7 policies x 2 modes x 3 seeds (tests/test_simulator.py's grid)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["batch", "continuous"])
@pytest.mark.parametrize("policy", ALL_POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_policy_matches_reference(seed, policy, mode):
    rows = random_workload(seed)
    views = []
    for side in SIDES:
        persona = side.personas.get_persona("dialogpt")
        pcfg = side.sched.PolicyConfig(u_scale=30.0, tau=35.0)
        res = side.sim.run_policy(tasks_for(side, rows), policy, persona,
                                  pcfg, mode=mode)
        # the same run traced: the slots live in the admit events
        ob = make_obs(side)
        pol = side.sched.POLICIES[policy](persona, pcfg)
        run = (side.sim.simulate_continuous if mode == "continuous"
               else side.sim.simulate)
        traced = run(tasks_for(side, rows), pol, obs=ob)
        views.append((result_view(res), result_view(traced), obs_view(ob)))
    for got, want in zip(views[1], views[0]):
        assert_same(got, want)
    assert len(views[1][0]["schedule"]) == len(rows)


# ---------------------------------------------------------------------------
# simulate_continuous with every feature of the model
# ---------------------------------------------------------------------------

SLOTS, BS, PROMPT = 3, 4, 8
CONTINUOUS = {
    # paged stall admission, a tight pool (deferred admissions), the
    # prefix cache over the shared prompt prefix, 2-step decode windows
    "paged-stall-prefix": dict(num_slots=SLOTS, kv_block_size=BS,
                               kv_num_blocks=9, prompt_len=PROMPT,
                               prefix_cache=True, decode_steps=2),
    # chunked prefill under a token budget, with the prefix cache
    "chunked-prefix": dict(num_slots=SLOTS, kv_block_size=BS,
                           kv_num_blocks=24, prompt_len=PROMPT,
                           prefill="chunked", chunk_size=4, token_budget=6,
                           prefix_cache=True, decode_steps=2),
    # chunked prefill, no prefix cache, one-step windows
    "chunked": dict(num_slots=SLOTS, kv_block_size=BS, kv_num_blocks=16,
                    prompt_len=PROMPT, prefill="chunked", chunk_size=3,
                    token_budget=5),
    # contiguous slots (no KV model), 3-step windows
    "contiguous": dict(num_slots=SLOTS, prompt_len=PROMPT, decode_steps=3),
}


@pytest.mark.parametrize("policy", ["fifo", "rt-lm"])
@pytest.mark.parametrize("row", list(CONTINUOUS))
def test_simulate_continuous_matches_reference(row, policy):
    rows = serving_workload(7)
    views = []
    for side in SIDES:
        persona = dataclasses.replace(
            side.personas.get_persona("bart"), batch_size=SLOTS)
        pol = side.sched.POLICIES[policy](
            persona, side.sched.PolicyConfig(u_scale=30.0, tau=8.0))
        ob = make_obs(side)
        kw = dict(CONTINUOUS[row])
        if kw.get("prefix_cache"):
            kw["prompt_tokens"] = prompt_tokens
        res = side.sim.simulate_continuous(
            tasks_for(side, rows), pol, xi=0.5, per_task_overhead_s=0.01,
            obs=ob, **kw)
        views.append((result_view(res), obs_view(ob)))
    for got, want in zip(views[1], views[0]):
        assert_same(got, want)
    res_view, ob_view = views[1]
    assert len(res_view["schedule"]) == len(rows)
    assert ob_view["calibration"]["count"] == len(rows)


def test_simulate_continuous_with_replica_faults_matches_reference():
    """One replica's fault slice: deadlines, shedding and a slowdown."""
    rows = serving_workload(3, n=30, spread=0.01)
    views = []
    for side in SIDES:
        persona = dataclasses.replace(
            side.personas.get_persona("bart"), batch_size=SLOTS)
        pol = side.sched.POLICIES["rt-lm"](
            persona, side.sched.PolicyConfig(u_scale=30.0, tau=1e18))
        rf = side.faults.ReplicaFaults(
            slowdowns=(side.faults.SlowFault(0, 2, 6, factor=3.0),),
            shed=side.faults.ShedPolicy(queue_depth=5,
                                        bulk_classes=("batch",)),
            deadlines=True)
        ob = make_obs(side)
        res = side.sim.simulate_continuous(
            tasks_for(side, rows), pol, xi=0.5, per_task_overhead_s=0.01,
            num_slots=SLOTS, kv_block_size=BS, kv_num_blocks=32,
            prompt_len=PROMPT, faults=rf, obs=ob)
        views.append((result_view(res), obs_view(ob)))
    for got, want in zip(views[1], views[0]):
        assert_same(got, want)
    assert views[1][0]["shed"] > 0 and views[1][0]["timed_out"] > 0


# ---------------------------------------------------------------------------
# simulate_replicated: every router, every fault mechanism
# ---------------------------------------------------------------------------


def fault_plan(side, R):
    """A crash at replica 0's step 3 (its survivors fail over to busy
    targets: entry R2's interleaved delivery), a slowed replica 1, a
    transient fault at the fifth placement, shedding past a queue of 4
    and deadlines."""
    f = side.faults
    return f.FaultPlan(
        crashes=(f.CrashFault(0, 3, recover_after_placements=6),),
        slowdowns=(f.SlowFault(1, 1, 5, factor=2.5),),
        transients=(f.TransientFault(at_placement=4),),
        retry=f.RetryPolicy(budget=2, seed=3),
        shed=f.ShedPolicy(queue_depth=4, bulk_classes=("batch",)),
        deadlines=True)


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("router", ["round_robin", "least_queue", "rtlm"])
def test_simulate_replicated_matches_reference(router, faulted):
    R = 3
    rows = serving_workload(11, n=36, spread=0.02)
    views = []
    for side in SIDES:
        persona = dataclasses.replace(
            side.personas.get_persona("bart"), batch_size=SLOTS)
        pol = side.sched.POLICIES["rt-lm"](
            persona, side.sched.PolicyConfig(u_scale=30.0, tau=1e18))
        rt = side.router.Router(R, router, bulk_replicas=(R - 1,),
                                bulk_classes=("batch",))
        ob = make_obs(side)
        res = side.sim.simulate_replicated(
            tasks_for(side, rows), pol, R=R, router=rt, xi=0.5,
            per_task_overhead_s=0.01, num_slots=SLOTS, kv_block_size=BS,
            kv_num_blocks=32, prompt_len=PROMPT,
            faults=fault_plan(side, R) if faulted else None, obs=ob)
        views.append((result_view(res), obs_view(ob),
                      [ob.trace.parity_events(replica=r)
                       for r in range(R)]))
    for got, want in zip(views[1], views[0]):
        assert got == want
    res_view = views[1][0]
    done = sum(len(r["schedule"]) for r in res_view["replicas"])
    assert (done + res_view["timed_out"] + res_view["shed"]
            + res_view["dead_lettered"]) == len(rows)
    if faulted:
        assert res_view["failovers"] > 0 and res_view["retries"] > 0
        assert res_view["replicas"][0]["crashed"]


# ---------------------------------------------------------------------------
# entry R1: the reference's falsifying example, reproduced
# ---------------------------------------------------------------------------


def test_entry_r1_continuous_later_than_batch_is_kept():
    """``out_len=3, n=20, rate=0.01953125, seed=1``: request 9 responds in
    0.5184 s under continuous batching against 0.5003 s in batch mode, in
    both packages (ROADMAP Queue 3 entry R1, kept as the reference's
    behaviour), though the mean response falls."""
    rng = np.random.default_rng(1)
    arrivals = np.cumsum(rng.exponential(0.01953125, 20))
    rows = [dict(u=5.0, r=float(r), d=float(r) + 4.0, input_len=5.0,
                 true_out_len=3, task_id=i, traffic_class="")
            for i, r in enumerate(arrivals)]
    runs = []
    for side in SIDES:
        persona = side.personas.get_persona("dialogpt")
        pcfg = side.sched.PolicyConfig(u_scale=30.0, tau=1e18)
        runs.append([side.sim.run_policy(tasks_for(side, rows), "fifo",
                                         persona, pcfg, mode=mode)
                     for mode in ("batch", "continuous")])
    views = [[result_view(r) for r in side] for side in runs]
    assert views[1] == views[0]
    batch, cont = ({t.task.task_id: t.response_time for t in r.tasks}
                   for r in runs[1])
    later = [i for i in batch if cont[i] > batch[i] + 1e-9]
    assert later == [9, 10]
    assert (round(batch[9], 4), round(cont[9], 4)) == (0.5003, 0.5184)
    assert runs[1][1].mean_response < runs[1][0].mean_response
