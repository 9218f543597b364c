"""PyTorch port: the traced engine (``ServingEngine(obs=Observability())``)
against the reference simulator and the JAX engine, on the CPU.

Each traced serve is held, in every row of the configuration matrix, to
``parity_events()`` (the lifecycle event stream less its wall-clock
fields), ``metrics.counters()``, ``slo.parity_counters()``,
``calibration.parity()`` and the health observation vector of
``simulate`` / ``simulate_continuous(obs=...)`` and of the JAX engine's
traced serve of the same requests:

  * paged stall (the tight pool) and chunked, N in {1, 4} (the reference's
    tests/test_obs.py and tests/test_slo.py grid);
  * batch mode, with an offload to the bulk lane; contiguous stall; paged
    stall with the prefix cache; chunked with a persistent prefix cache
    served twice, each serve into its own bundle.

The SLO targets are the reference tests' judgment-invariant ones (``inf``
always attains, ``-1.0`` never), so the counts compare exactly although
the clocks are wall clocks.  The two frameworks' m_theta agree to float
tolerance, not bit for bit, so the JAX engine scores with the port's
m_theta (the simulator is fed the same ``u``); one test serves the JAX
engine with its own and finds only ``u`` apart.

Also: ``obs=None`` changes no deterministic result, the port's JSONL reads
in the reference's ``load_jsonl``, ``scripts/trace_report.py`` and
``scripts/slo_report.py``, timelines rebuilt from it give the result's
TTFT/ITL quantiles, and ``pipeline.collect_wait_s`` is recorded.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import simulator  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
CLS = ["interactive", "batch"] * (len(es.CAPS) // 2)
HEALTH_KEYS = ("step", "queue_depth", "active", "kv_util", "drift",
               "calibration_count")
FAULT_KINDS = {"timeout", "shed", "retry", "failover", "replica_down",
               "replica_up", "dead_letter"}

PAGED = dict(mode="continuous", kv="paged", kv_block_size=es.BS)
CHUNKED = dict(prefill="chunked", chunk_size=es.CHUNK,
               token_budget=es.BUDGET)
# the reference obs tests' grid: the tight pool for stall, the default
# pool for chunked
GRID = {"stall": dict(PAGED, prefill="stall", **es.TIGHT),
        "chunked": dict(PAGED, num_slots=es.SLOTS, **CHUNKED)}
# the other rows: (policy, tau, engine arguments, prefix workload)
ROWS = {
    "batch": ("fifo", 1e18, {}, False),
    "batch-offload": ("rt-lm", 0.0, {}, False),
    "contiguous-stall": ("fifo", 1e18, dict(mode="continuous",
                                            decode_steps=2), False),
    "paged-stall-prefix": ("fifo", 1e18, dict(PAGED, prefix_cache=True,
                                              decode_steps=2), True),
}
PERSIST = dict(PAGED, prefix_cache=True, persist_prefix_cache=True,
               **CHUNKED)


def make_obs(mod):
    """The full bundle: trace, metrics, SLO monitor over the two classes,
    calibration ledger, a snapshot every two decode steps."""
    targets = {"interactive": mod.SLOSpec(),
               "batch": mod.SLOSpec(ttft_s=-1.0, itl_s=-1.0, e2e_s=-1.0,
                                    queue_wait_s=-1.0)}
    return mod.Observability(slo=targets, calibration=True,
                             snapshot_every_steps=2)


@pytest.fixture(scope="module")
def setup():
    s = es.make_setup()
    corpus = s["texts"]
    words = [(t.split() * 2)[:4] for t in corpus[:5]]
    # tests/test_torch_prefix.py's shared-prefix workload
    s["prefix_texts"] = [corpus[i] if i % 4 == 0 else
                         " ".join(["shared", "system", "prompt", "here"]
                                  + words[i % 5])
                         for i in range(len(es.CAPS))]
    return s


def _texts(s, prefix: bool):
    return s["prefix_texts"] if prefix else s["texts"]


def _port(s, policy_name, tau, texts, traced=True, **kw):
    ob = make_obs(tobs) if traced else None
    eng = es.port_engine(s, policy_name, tau, obs=ob, **kw)
    res = eng.serve(es.requests(tengine, texts, classes=CLS))
    return eng, res, ob


def _jax(s, policy_name, tau, texts, own_u=False, **kw):
    ob = make_obs(jobs)
    eng = es.jax_engine(s, policy_name, tau, obs=ob, **kw)
    if not own_u:
        eng.profile = dataclasses.replace(
            eng.profile, predictor=es.PortScores(s["tprof"].predictor))
    res = eng.serve(es.requests(jengine, texts, classes=CLS))
    return eng, res, ob


@pytest.fixture(scope="module")
def serve(setup):
    """Memoized serves, one per (side, row, N)."""
    memo = {}

    def _serve(side, row, n=1, traced=True):
        key = (side, row, n, traced)
        if key not in memo:
            if row in GRID:
                policy_name, tau, kw, prefix = ("fifo", 1e18, dict(
                    GRID[row], decode_steps=n), False)
            else:
                policy_name, tau, kw, prefix = ROWS[row]
            texts = _texts(setup, prefix)
            if side == "port":
                memo[key] = _port(setup, policy_name, tau, texts, traced,
                                  **kw)
            else:
                memo[key] = _jax(setup, policy_name, tau, texts, **kw)
        return memo[key]

    return _serve


def _sim(s, row, n, eng, ob, prefix_state=None):
    """The simulator's traced run of a row, fed the port's ``u``."""
    if row == "persist":
        policy_name, tau, prefix = "fifo", 1e18, True
        kw = dict(num_slots=es.SLOTS, prefill="chunked", chunk_size=es.CHUNK,
                  token_budget=es.BUDGET, decode_steps=1,
                  prefix_state=prefix_state)
    elif row in GRID:
        policy_name, tau, prefix = "fifo", 1e18, False
        kw = dict(num_slots=eng.num_slots, decode_steps=n)
        if row == "chunked":
            kw.update(prefill="chunked", chunk_size=es.CHUNK,
                      token_budget=es.BUDGET)
    else:
        policy_name, tau, _, prefix = ROWS[row]
        kw = dict(decode_steps=eng.decode_steps)
    tasks = es.sim_tasks(s, _texts(s, prefix), classes=CLS)
    policy = es.jax_policy(s, policy_name, tau)
    if eng.mode == "batch":
        return simulator.simulate(tasks, policy, obs=ob)
    kw["prompt_len"] = es.BUCKET          # the prefill_chunk events' length
    if eng.kv == "paged":
        kw.update(kv_block_size=es.BS, kv_num_blocks=eng.kv_num_blocks)
    if eng.prefix_cache_enabled:
        kw.update(prefix_cache=True,
                  prompt_tokens=es.prompt_tokens_fn(s["cfg"]))
    return simulator.simulate_continuous(tasks, policy, obs=ob, **kw)


def view(ob) -> dict:
    """Everything of a bundle that compares exactly across frameworks."""
    return {"events": ob.trace.parity_events(),
            "counters": ob.metrics.counters(),
            "slo": ob.slo.parity_counters(),
            "calibration": ob.calibration.parity(),
            "health": [{k: h[k] for k in HEALTH_KEYS}
                       for h in ob.health_trace]}


def assert_same_view(got, want):
    for key in want:
        assert got[key] == want[key], key


def assert_recorded(res, ob, n_tasks=len(es.CAPS)):
    """What a port serve's bundle must hold in itself: known event kinds
    and no fault kind, counters equal to the result's mirrors, the
    classes' judgments and the calibration ledger."""
    kinds = {e.kind for e in ob.trace.events}
    assert kinds <= tobs.EVENT_KINDS and not kinds & FAULT_KINDS
    c = ob.metrics.counters()
    assert c["sched.completions"] == n_tasks
    assert c["prefill.dispatches"] == res["prefill_dispatches"]
    assert c.get("decode.dispatches", 0) == res["decode_dispatches"]
    assert c.get("decode.steps", 0) == res["decode_steps_executed"]
    assert c.get("exec_cache.hits", 0) == res["exec_cache_hits"]
    assert c.get("exec_cache.misses", 0) == res["exec_cache_misses"]
    assert res["fallback_events"] == 0
    pc = ob.slo.parity_counters()
    for m in tobs.SLO_METRICS:
        if pc.get(f"slo.interactive.{m}.total"):
            assert pc[f"slo.interactive.{m}.ok"] \
                == pc[f"slo.interactive.{m}.total"]
        assert pc.get(f"slo.batch.{m}.ok", 0) == 0
    assert pc["slo.interactive.completions"] \
        + pc["slo.batch.completions"] == n_tasks
    cal = ob.calibration.parity()
    assert cal["count"] == n_tasks
    # EOS is disabled: the realised length is the cap
    want = sum(t.u - t.task.out_len for t in res["tasks"])
    assert cal["err_sum"] == pytest.approx(want)
    assert res["slo_attainment"] == ob.slo.attainment()
    assert res["calibration"]["count"] == n_tasks
    assert res["health_trace"] == ob.health_trace


# ---------------------------------------------------------------------------
# the reference tests' grid: paged stall (tight pool) and chunked, N in {1, 4}
# ---------------------------------------------------------------------------

GRID_CASES = [("stall", 1), ("stall", 4), ("chunked", 1), ("chunked", 4)]


@pytest.mark.parametrize("row,n", GRID_CASES)
def test_grid_vs_sim(setup, serve, row, n):
    eng, res, ob = serve("port", row, n)
    sob = make_obs(jobs)
    sim = _sim(setup, row, n, eng, sob)
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]
    assert_same_view(view(ob), view(sob))
    assert any(e.kind == "snapshot" for e in ob.trace.events)
    if row == "stall":
        assert ob.metrics.counters()["sched.rejections"] > 0
    assert res["fallback_events"] == sim.fallback_events == 0
    assert res["slo_attainment"].keys() == sim.slo_attainment.keys()
    assert res["calibration"]["count"] == sim.calibration["count"]


@pytest.mark.parametrize("row,n", GRID_CASES)
def test_grid_vs_jax_engine(serve, row, n):
    eng, res, ob = serve("port", row, n)
    jeng, want, job = serve("jax", row, n)
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    assert_same_view(view(ob), view(job))
    assert eng.health() == ob.health_trace[-1]
    assert {k: eng.health()[k] for k in HEALTH_KEYS} \
        == {k: jeng.health()[k] for k in HEALTH_KEYS}


@pytest.mark.parametrize("row,n", GRID_CASES)
def test_grid_records_what_the_result_says(serve, row, n):
    _, res, ob = serve("port", row, n)
    assert_recorded(res, ob)
    # one span and one event per decode window, carrying its dt
    spans = [sp for sp in ob.trace.spans if sp.name == "decode.window"]
    wins = [e for e in ob.trace.events if e.kind == "decode_window"]
    assert len(spans) == len(wins) == res["decode_dispatches"]
    for sp, e in zip(spans, wins):
        assert sp.dur == e.fields["dur"] > 0.0
        assert sp.ts + sp.dur == pytest.approx(e.ts)
    name = "prefill.ragged" if row == "chunked" else "prefill.admit"
    assert len([sp for sp in ob.trace.spans if sp.name == name]) \
        == res["prefill_dispatches"]
    assert len([c for c in ob.trace.counters if c[0] == "kv.util"]) \
        == res["decode_dispatches"]
    g = ob.metrics.gauge("kv.util")
    assert g.n == res["decode_dispatches"]
    assert g.max == res["kv_util_peak"]


# ---------------------------------------------------------------------------
# the other rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", list(ROWS))
def test_row_vs_jax_engine(serve, row):
    _, res, ob = serve("port", row)
    _, want, job = serve("jax", row)
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    assert_same_view(view(ob), view(job))
    assert_recorded(res, ob)
    kinds = {e.kind for e in ob.trace.events}
    if row == "batch-offload":
        assert "cpu" in {t.task.lane for t in res["tasks"]}
        assert [sp.fields["lane"] for sp in ob.trace.spans] \
            == [sp.fields["lane"] for sp in job.trace.spans]
    if row == "paged-stall-prefix":
        assert {"prefix_hit", "exec_cache"} <= kinds
        assert ob.metrics.counters()["prefix.hit_blocks"] > 0
        assert ob.metrics.counters()["prefix.cow_copies"] \
            == res["cow_copies"] > 0


@pytest.mark.parametrize("row", ["batch", "contiguous-stall",
                                 "paged-stall-prefix"])
def test_row_vs_sim(setup, serve, row):
    eng, res, ob = serve("port", row)
    sob = make_obs(jobs)
    sim = _sim(setup, row, 1, eng, sob)
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]
    assert_same_view(view(ob), view(sob))
    assert res["fallback_events"] == sim.fallback_events == 0


def test_persistent_prefix_cache_two_serves(setup):
    """Chunked prefill with the prefix cache kept across two serves, each
    serve recording into its own bundle: the cache's ``prefix.*``
    counters go to the serve in flight, not to the serve that built the
    cache; both serves equal the JAX engine's and the simulator's (one
    ``make_prefix_state`` across both runs)."""
    texts = setup["prefix_texts"]
    eng = es.port_engine(setup, "fifo", **PERSIST)
    jeng = es.jax_engine(setup, "fifo", **PERSIST)
    jeng.profile = dataclasses.replace(
        jeng.profile, predictor=es.PortScores(setup["tprof"].predictor))
    state = simulator.make_prefix_state(eng.kv_num_blocks, es.BS)
    views = []
    for k in range(2):
        eng.obs, jeng.obs = make_obs(tobs), make_obs(jobs)
        res = eng.serve(es.requests(tengine, texts, classes=CLS))
        want = jeng.serve(es.requests(jengine, texts, classes=CLS))
        sob = make_obs(jobs)
        sim = _sim(setup, "persist", 1, eng, sob, prefix_state=state)
        assert res["completion_order"] == want["completion_order"] \
            == [t.task.task_id for t in sim.tasks]
        assert es.tokens(res) == es.tokens(want)
        assert_same_view(view(eng.obs), view(jeng.obs))
        assert_same_view(view(eng.obs), view(sob))
        assert_recorded(res, eng.obs)
        c = eng.obs.metrics.counters()
        assert c.get("prefix.hit_blocks", 0) == eng.prefix_cache.hit_blocks
        views.append(view(eng.obs))
    assert views[1]["counters"]["prefix.hit_blocks"] \
        > views[0]["counters"].get("prefix.hit_blocks", 0)
    eng.prefix_cache.clear()
    eng.allocator.check_no_leaks()


def test_reference_m_theta_differs_only_in_u(setup, serve):
    """With the reference's own m_theta the JAX engine's stream differs
    from the port's only in the admit events' ``u``, by float rounding."""
    _, _, ob = serve("port", "stall", 1)
    _, _, job = _jax(setup, "fifo", 1e18, setup["texts"], own_u=True,
                     **GRID["stall"], decode_steps=1)

    def split(events):
        rest, us = [], []
        for kind, tid, step, payload in events:
            us += [v for k, v in payload if k == "u"]
            rest.append((kind, tid, step,
                         tuple(kv for kv in payload if kv[0] != "u")))
        return rest, us

    got, want = split(ob.trace.parity_events()), \
        split(job.trace.parity_events())
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert ob.metrics.counters() == job.metrics.counters()
    assert ob.slo.parity_counters() == job.slo.parity_counters()


# ---------------------------------------------------------------------------
# recording changes nothing; the exports
# ---------------------------------------------------------------------------

#: tests/test_obs.py::test_obs_none_results_unchanged's deterministic keys
DETERMINISTIC = ("completion_order", "prefill_dispatches",
                 "prefill_dispatch_trace", "decode_dispatches",
                 "decode_dispatch_trace", "decode_steps_executed",
                 "rejected_for_memory", "exec_cache_hits",
                 "exec_cache_misses", "fallback_events")


@pytest.mark.parametrize("row,n", [("stall", 1), ("chunked", 4),
                                   ("batch-offload", 1),
                                   ("paged-stall-prefix", 1)])
def test_obs_none_results_unchanged(serve, row, n):
    _, plain, none = serve("port", row, n, traced=False)
    _, traced, _ = serve("port", row, n)
    assert none is None
    for key in DETERMINISTIC + ("budget_trace", "kv_util_peak",
                                "kv_util_mean", "cow_copies",
                                "prefix_hit_rate"):
        assert plain[key] == traced[key], key
    assert es.tokens(plain) == es.tokens(traced)
    assert plain["obs_overhead_s"] == 0.0 < traced["obs_overhead_s"]
    assert plain["slo_attainment"] == {} and plain["calibration"] == {}
    assert plain["health_trace"] == []


def test_traced_serve_reconstructs_latencies(serve, tmp_path):
    """The reference's tests/test_obs.py:501 on the port: the exported
    trace reloads with the same parity events and its timelines give the
    result's TTFT / ITL / queue-wait quantiles within the histogram's
    relative error."""
    _, res, ob = serve("port", "chunked", 4)
    path = ob.trace.export_perfetto(str(tmp_path / "serve.json"))
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    back = tobs.TraceRecorder.load_jsonl(
        ob.trace.to_jsonl(str(tmp_path / "serve.jsonl")))
    assert back.parity_events() == ob.trace.parity_events()
    tls = tobs.timelines(back)
    assert len(tls) == len(es.CAPS)
    ttft, itl, qw = (tobs.Histogram() for _ in range(3))
    for t in tls.values():
        ttft.record(t.ttft)
        qw.record(t.queue_wait)
        for v in t.itls:
            itl.record(v)
        assert t.cls == CLS[t.task_id] and t.chunks >= 1
    tol = np.sqrt(tobs.Histogram.GROWTH) - 1.0
    for key, h, q in (("ttft_p50", ttft, 0.50), ("ttft_p99", ttft, 0.99),
                      ("itl_p50", itl, 0.50), ("itl_p99", itl, 0.99),
                      ("queue_wait_p50", qw, 0.50),
                      ("queue_wait_p99", qw, 0.99)):
        assert res[key] == pytest.approx(h.quantile(q), rel=2 * tol), key


def _script(name):
    sys.path.insert(0, SCRIPTS)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_port_trace_reads_in_the_references_tools(serve, tmp_path,
                                                  capsys):
    """A traced port serve's JSONL loads in the reference's
    ``TraceRecorder.load_jsonl`` with the same parity events, and
    ``scripts/trace_report.py`` and ``scripts/slo_report.py`` report it."""
    _, _, ob = serve("port", "stall", 4)
    path = ob.trace.to_jsonl(str(tmp_path / "port.jsonl"))
    back = jobs.TraceRecorder.load_jsonl(path)
    assert back.parity_events() == ob.trace.parity_events()
    assert back.meta == ob.trace.meta and back.meta["slo"]
    assert _script("trace_report").main([path]) == 0
    assert "ttft_s" in capsys.readouterr().out
    sr = _script("slo_report")
    assert sr.main([path, "--json"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["requests"] == len(es.CAPS) and stats["snapshots"] > 0
    assert set(stats["classes"]) >= {"interactive", "batch"}
    assert stats["calibration"]["count"] == len(es.CAPS)


@pytest.mark.parametrize("row,n", [("stall", 4), ("chunked", 1)])
def test_collect_wait_recorded(serve, row, n):
    """Every ``CompletionWorker.collect`` of the serve (one per decode
    window, and one per fused prefill in the chunked loop) lands in
    ``pipeline.collect_wait_s``, and each snapshot's ``wall`` carries it."""
    _, res, ob = serve("port", row, n)
    h = ob.metrics.histogram("pipeline.collect_wait_s")
    collects = res["decode_dispatches"] + (
        res["prefill_dispatches"] if row == "chunked" else 0)
    assert h.count == collects and h.min >= 0.0
    walls = [snap["wall"]["collect_wait"] for snap in ob.health_trace]
    assert walls and all(w["count"] <= collects for w in walls)
    assert [w["count"] for w in walls] == sorted(w["count"] for w in walls)
