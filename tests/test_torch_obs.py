"""PyTorch port: the observability copies against the reference.

``repro_torch.obs`` (metrics, log, trace, slo, calibration, the
``Observability`` bundle) and ``repro_torch.core.workload`` are
framework-free copies of ``repro.obs`` and ``repro.core.workload``.  Each
test drives the copy and the reference through the same inputs, made from
a numpy seed, and compares everything observable:

  * ``Counter`` / ``Gauge`` / ``MetricsRegistry`` (``counters()``, the
    parity view, ``snapshot``, ``merge``) and ``percentiles``;
  * ``WindowedHistogram`` rotation on the virtual clock, ``SLOMonitor``
    attainment, windowed attainment and ``parity_counters``;
  * ``CalibrationLedger`` (``parity``, ``drift``, ``reliability``,
    ``summary``) and ``u_bucket``;
  * ``RateLimitedLogger``, ``scope`` and ``warn_once``;
  * ``TraceRecorder`` JSONL and Perfetto output (byte for byte), each
    side's JSONL loaded by the other, ``timelines``, the budget guard,
    the ``Observability`` emitters (snapshots and replica labels too);
  * the workload helpers (traffic classes, class assignment, deadlines,
    arrival traces); ``EVENT_KINDS`` and ``WALL_FIELDS`` as sets.

A JSONL the port writes is reported by ``scripts/trace_report.py`` and
``scripts/slo_report.py``; ``CompletionWorker`` records its collect waits.
"""

import json
import logging
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.core import workload as jwork  # noqa: E402
from repro.obs import log as jlog  # noqa: E402
from repro.obs import metrics as jmet  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import workload as twork  # noqa: E402
from repro_torch.obs import log as tlog  # noqa: E402
from repro_torch.obs import metrics as tmet  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.serving.pipeline import CompletionWorker  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
SEEDS = range(3)
BOTH = (jobs, tobs)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _drive_registry(met, seed: int):
    """Seeded counter / gauge / histogram traffic into two registries,
    merged; returns everything observable."""
    rng = np.random.default_rng(seed)
    regs = [met.MetricsRegistry(), met.MetricsRegistry()]
    for _ in range(200):
        r = regs[rng.integers(0, 2)]
        op = rng.integers(0, 3)
        name = f"m{rng.integers(0, 4)}"
        if op == 0:
            r.counter("c." + name).inc(int(rng.integers(1, 5)))
        elif op == 1:
            r.gauge("g." + name).set(float(rng.uniform(-1.0, 2.0)))
        else:
            r.histogram("h." + name).record(float(rng.lognormal(0.0, 1.5)),
                                            int(rng.integers(1, 3)))
    out = [regs[0].counters(), regs[1].snapshot()]
    regs[0].merge(regs[1])
    out += [regs[0].counters(), regs[0].snapshot()]
    g = met.Gauge()
    out.append((g.mean, g.snapshot()))
    c = met.Counter()
    c.inc(3)
    out.append(c.merge(met.Counter()).snapshot())
    vals = rng.pareto(1.5, 300) + 1e-3
    h = met.percentiles(vals, regs[0], "extra")
    out += [regs[0].histogram("extra") is h,
            h.quantiles((0.0, 0.5, 0.9, 0.99, 1.0)),
            met.percentiles(vals).snapshot()]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_metrics_registry_matches_reference(seed):
    assert _drive_registry(tmet, seed) == _drive_registry(jmet, seed)


def test_registry_merge_rejects_mixed_growth():
    for met in (jmet, tmet):
        a, b = met.MetricsRegistry(), met.MetricsRegistry()
        a.histogram("x")
        b.histogram("x", growth=1.5).record(1.0)
        with pytest.raises(ValueError, match="different growth"):
            a.merge(b)


# ---------------------------------------------------------------------------
# SLO monitor
# ---------------------------------------------------------------------------


def _drive_windowed(slo, seed: int):
    rng = np.random.default_rng(seed)
    w = slo.WindowedHistogram(window_s=2.0, num_windows=3)
    ts = np.cumsum(rng.exponential(0.4, 120))
    out = []
    for t in ts:
        w.record(float(t), float(rng.lognormal(-3.0, 1.0)),
                 int(rng.integers(1, 3)))
        if rng.random() < 0.2:
            w.advance(float(t) + float(rng.uniform(0.0, 5.0)))
            out.append((w.count, w.quantile(0.5), w.snapshot(),
                        w.lifetime().snapshot()))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_windowed_histogram_rotation_matches_reference(seed):
    got, want = _drive_windowed(tslo, seed), _drive_windowed(jslo, seed)
    assert got == want and len(want) > 5


def _drive_monitor(slo, seed: int):
    rng = np.random.default_rng(seed)
    mon = slo.SLOMonitor({
        "interactive": slo.SLOSpec(ttft_s=0.05, itl_s=0.01),
        "batch": slo.SLOSpec(e2e_s=1.0, queue_wait_s=0.2)},
        window_s=1.0, num_windows=4)
    out = []
    t = 0.0
    for _ in range(300):
        t += float(rng.exponential(0.05))
        cls = ["interactive", "batch", "", "other"][rng.integers(0, 4)]
        metric = slo.SLO_METRICS[rng.integers(0, 4)]
        replica = None if rng.random() < 0.5 else int(rng.integers(0, 2))
        mon.observe(metric, cls, t, float(rng.lognormal(-3.0, 1.2)),
                    int(rng.integers(1, 3)), replica=replica)
        if rng.random() < 0.1:
            out.append(mon.complete(cls, replica=replica))
        if rng.random() < 0.05:
            out.append(mon.windowed_attainment())
    out += [mon.attainment(), mon.parity_counters(),
            mon.replica_attainment(), mon.targets_json(),
            mon.lifetime_quantile("batch", "e2e", 0.9)]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_slo_monitor_matches_reference(seed):
    assert _drive_monitor(tslo, seed) == _drive_monitor(jslo, seed)


def test_slospec_json_and_unknown_metric():
    for slo in (jslo, tslo):
        spec = slo.SLOSpec(ttft_s=0.5, e2e_s=3.0)
        assert slo.SLOSpec.from_json(spec.to_json()) == spec
        assert spec.target("itl") == math.inf
        with pytest.raises(KeyError):
            slo.SLOMonitor().observe("tpot", "", 0.0, 1.0)
    assert tslo.SLO_METRICS == jslo.SLO_METRICS
    assert tslo.SLOSpec().to_json() == jslo.SLOSpec().to_json()


# ---------------------------------------------------------------------------
# calibration ledger
# ---------------------------------------------------------------------------


def _drive_ledger(mod, seed: int):
    rng = np.random.default_rng(seed)
    led = mod.CalibrationLedger(drift_window=16, drift_windows=3)
    out = []
    for i in range(150):
        shift = 0.0 if i < 80 else 20.0
        u = float(rng.uniform(0.0, 60.0))
        led.record(u, int(rng.integers(1, 64) + shift),
                   float(rng.lognormal(0.0, 1.0)) if i % 3 else None)
        if i % 10 == 0:
            out.append((led.drift(), led.mae, led.bias))
    out += [led.parity(), led.reliability(), led.summary(),
            [mod.u_bucket(u) for u in (0.0, 0.5, 1.0, 3.9, 4.0, 1e6)]]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_calibration_ledger_matches_reference(seed):
    got = _drive_ledger(tobs, seed)
    assert got == _drive_ledger(jobs, seed)
    assert got[-4]["drift"] > 0.0                  # the shift is detected


def test_calibration_ledger_validates():
    for mod in BOTH:
        for kw in (dict(drift_window=0), dict(drift_windows=0)):
            with pytest.raises(ValueError):
                mod.CalibrationLedger(**kw)


# ---------------------------------------------------------------------------
# rate-limited logging
# ---------------------------------------------------------------------------


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def _drive_logging(log, name: str):
    lg = logging.getLogger(name)
    lg.propagate = False
    cap = _Capture()
    lg.addHandler(cap)
    lg.setLevel(logging.WARNING)
    try:
        rl = log.RateLimitedLogger(min_interval_s=3600.0)
        emitted = [rl.warn(lg, "k", "warn %d", i) for i in range(4)]
        rl.reset("k")
        emitted.append(rl.warn(lg, "k", "again"))
        rl.reset()
        key = "test-torch-obs-scoped"     # each package's own FALLBACKS
        base = log.FALLBACKS.count(key)
        a, b = log.RateLimitedLogger(), log.RateLimitedLogger()
        with log.scope(a):
            emitted += [log.warn_once(lg, key, "a"),
                        log.warn_once(lg, key, "a again")]
            with log.scope(b):
                emitted.append(log.warn_once(lg, key, "b"))
        emitted.append(log.warn_once(lg, key, "unscoped"))
        return (emitted, cap.records, rl.counts, rl.suppressed,
                rl.count(), rl.count("k"), a.counts, b.counts,
                log.FALLBACKS.count(key) - base,
                log.fallback_count() >= log.FALLBACKS.count(key))
    finally:
        lg.removeHandler(cap)


def test_rate_limited_logging_matches_reference():
    got = _drive_logging(tlog, "test.torch.obs.port")
    want = _drive_logging(jlog, "test.torch.obs.ref")
    assert got == want
    emitted, records = got[0], got[1]
    assert emitted[:5] == [True, False, False, False, True]
    assert records[:2] == ["warn 0", "again"]


def test_port_ledger_is_its_own():
    """The port's ``FALLBACKS`` and scopes are not the reference's: an
    engine ledger of one package never counts the other's warnings."""
    assert tlog.FALLBACKS is not jlog.FALLBACKS
    led = tlog.RateLimitedLogger()
    with tlog.scope(led):
        jlog.warn_once(logging.getLogger("test.torch.obs.x"), "k", "x")
    assert led.count() == 0


# ---------------------------------------------------------------------------
# trace: recorder, exports, timelines, the bundle's emitters
# ---------------------------------------------------------------------------


def _drive_bundle(mod, seed: int, replica=None):
    """A seeded lifecycle through the ``Observability`` emitters of one
    package: classes, admissions, chunks, tokens, completions, windows,
    snapshots; ``replica`` labels every stream."""
    rng = np.random.default_rng(seed)
    ob = mod.Observability(
        slo={"interactive": mod.SLOSpec(ttft_s=0.5),
             "batch": mod.SLOSpec(e2e_s=2.0)},
        calibration=True, snapshot_every_steps=2)
    ob.replica_label = replica
    now, step = 0.0, 0
    for tid in range(6):
        cls = ["interactive", "batch", ""][tid % 3]
        ob.event("enqueue", now, tid, step, **({"cls": cls} if cls else {}))
    for tid in range(6):
        cls = ["interactive", "batch", ""][tid % 3]
        u = float(rng.uniform(1.0, 40.0))
        now += float(rng.uniform(0.0, 0.1))
        ob.event("admit", now, tid, step, slot=tid % 3, u=u, kv_blocks=2)
        ob.inc("sched.admissions")
        ob.observe("queue_wait_s", now)
        ob.slo_observe("queue_wait", cls, now, now)
        dt = float(rng.uniform(0.01, 0.05))
        now += dt
        ob.span("prefill.admit", now - dt, dt, task=tid, slot=tid % 3)
        ob.event("prefill_chunk", now, tid, step, slot=tid % 3, start=0,
                 length=8, finishes=True, shape_key="admit")
        ob.event("first_token", now, tid, step, slot=tid % 3)
        ob.slo_observe("ttft", cls, now, now)
        first = now
        for k in range(1, int(rng.integers(2, 5))):
            dt = float(rng.uniform(0.005, 0.02))
            now += dt
            step += 1
            ob.inc("decode.steps")
            ob.gauge("kv.util", float(rng.uniform()))
            ob.counter_sample("kv.util", now, float(rng.uniform()))
            ob.span("decode.window", now - dt, dt, steps=1, active=1)
            ob.event("decode_window", now, None, step, steps=1, active=1,
                     dur=dt)
            ob.event("token", now, tid, step, slot=tid % 3, idx=k + 1)
            ob.slo_observe("itl", cls, now, dt)
            ob.maybe_snapshot(now, step, queue_depth=5 - tid, active=1,
                              kv_util=0.5, wall={"collect_wait": {}})
        ob.event("complete", now, tid, step, lane="gpu", out_len=k + 1)
        ob.inc("sched.completions")
        ob.complete_request(cls, now, u=u, out_len=k + 1,
                            latency_s=now - first)
        ob.event("evict", now, tid, step, slot=tid % 3)
    with ob.measure():
        pass
    return ob


@pytest.mark.parametrize("replica", [None, 2])
@pytest.mark.parametrize("seed", SEEDS)
def test_bundle_exports_match_reference(tmp_path, seed, replica):
    """The same emitter calls give byte-identical JSONL and an equal
    Perfetto document, counters, SLO and calibration state, health
    trace; each side's JSONL loads in the other's recorder."""
    t, j = _drive_bundle(tobs, seed, replica), _drive_bundle(jobs, seed,
                                                             replica)
    pt = t.trace.to_jsonl(str(tmp_path / "port.jsonl"))
    pj = j.trace.to_jsonl(str(tmp_path / "ref.jsonl"))
    with open(pt) as a, open(pj) as b:
        assert a.read() == b.read()
    assert t.trace.to_perfetto() == j.trace.to_perfetto()
    assert t.metrics.snapshot() == j.metrics.snapshot()
    assert t.slo.attainment() == j.slo.attainment()
    assert t.slo.parity_counters() == j.slo.parity_counters()
    assert t.calibration.summary() == j.calibration.summary()
    assert t.health_trace == j.health_trace and t.health() == j.health()
    assert t.event_count() == j.event_count()
    assert t.trace.parity_events(replica) == j.trace.parity_events(replica)
    for path in (pt, pj):
        a = tobs.TraceRecorder.load_jsonl(path)
        b = jobs.TraceRecorder.load_jsonl(path)
        assert a.parity_events() == b.parity_events() \
            == t.trace.parity_events()
        assert a.meta == b.meta == t.trace.meta
        assert a.counters == b.counters == t.trace.counters
        assert [s.to_json() for s in a.spans] \
            == [s.to_json() for s in t.trace.spans]
    doc = tobs.TraceRecorder.load_jsonl(pt).export_perfetto(
        str(tmp_path / "p.json"))
    with open(doc) as f:
        assert json.load(f) == t.trace.to_perfetto()


@pytest.mark.parametrize("seed", SEEDS)
def test_timelines_match_reference(seed):
    t, j = _drive_bundle(tobs, seed), _drive_bundle(jobs, seed)
    a, b = tobs.timelines(t.trace), jobs.timelines(j.trace)
    assert list(a) == list(b) == list(range(6))
    for tid in a:
        x, y = a[tid], b[tid]
        assert (x.ttft, x.e2e, x.queue_wait, x.itls, x.cls, x.u, x.out_len,
                x.chunks, x.rejected) == (y.ttft, y.e2e, y.queue_wait,
                                          y.itls, y.cls, y.u, y.out_len,
                                          y.chunks, y.rejected)
    assert t.trace.task_ids() == j.trace.task_ids()


def test_trace_budget_guard_and_disabled_pieces():
    for mod in BOTH:
        rec = mod.TraceRecorder(max_events=3)
        for i in range(6):
            rec.event("token", float(i), 0, 0, slot=0, idx=i)
        rec.span("x", 0.0, 1.0)
        assert len(rec.events) == 3 and rec.dropped == 4
        ob = mod.Observability(trace=False, metrics=False)
        ob.event("enqueue", 0.0, 0)
        ob.span("x", 0.0, 1.0)
        ob.counter_sample("c", 0.0, 1.0)
        ob.inc("n")
        ob.gauge("g", 1.0)
        ob.observe("h", 1.0)
        ob.complete_request("", 0.0, u=1.0, out_len=1)
        ob.maybe_snapshot(0.0, 4, queue_depth=0, active=0, kv_util=0.0)
        assert ob.event_count() == 0 and ob.health() == {}


def test_vocabulary_equal_to_reference():
    assert tobs.EVENT_KINDS == jobs.EVENT_KINDS
    assert tobs.WALL_FIELDS == jobs.WALL_FIELDS
    # the fault kinds replicas and faults will emit are there already
    assert {"timeout", "shed", "retry", "failover", "replica_down",
            "replica_up", "dead_letter"} <= tobs.EVENT_KINDS
    assert sorted(tobs.__all__) == sorted(jobs.__all__)


def test_port_jsonl_reported_by_reference_scripts(tmp_path, capsys):
    """``scripts/trace_report.py`` and ``scripts/slo_report.py`` (the
    reference's tools) report a JSONL the port wrote."""
    path = _drive_bundle(tobs, 0).trace.to_jsonl(str(tmp_path / "p.jsonl"))
    sys.path.insert(0, SCRIPTS)
    try:
        import slo_report
        import trace_report
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "p.json")
    assert trace_report.main([path, "--perfetto", out]) == 0
    assert "waterfall" in capsys.readouterr().out
    assert trace_report.main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["requests"] == 6
    assert slo_report.main([path]) == 0
    text = capsys.readouterr().out
    assert "reliability" in text and "queue_depth" in text
    assert slo_report.main([path, "--json"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["snapshots"] > 0 and stats["calibration"]["count"] == 6


# ---------------------------------------------------------------------------
# workload: traffic classes and arrival traces
# ---------------------------------------------------------------------------

SPEC = {"interactive": {"slo": {"ttft_s": 2.5, "itl_s": 0.02},
                        "weight": 3.0, "max_new_tokens": 32},
        "batch": {"e2e_s": 60.0},
        "bulk": {"slo": {"e2e_s": 600.0}, "weight": 0.5, "bulk": True}}


def _classes(work):
    classes = work.make_traffic_classes(SPEC)
    return classes, [dict(name=c.name, slo=c.slo.to_json(), weight=c.weight,
                          max_new_tokens=c.max_new_tokens, bulk=c.bulk)
                     for c in classes]


def test_traffic_classes_match_reference():
    tc, tview = _classes(twork)
    jc, jview = _classes(jwork)
    assert tview == jview
    assert isinstance(tc[0].slo, tslo.SLOSpec)
    assert twork.bulk_class_names(tc) == jwork.bulk_class_names(jc) \
        == ["bulk"]
    tt, jt = twork.slo_targets(tc), jwork.slo_targets(jc)
    assert {k: v.to_json() for k, v in tt.items()} \
        == {k: v.to_json() for k, v in jt.items()}
    for cls in ("interactive", "batch", "bulk", "unknown"):
        assert twork.request_deadline(3.0, cls, tt) \
            == jwork.request_deadline(3.0, cls, jt)


@pytest.mark.parametrize("seed", SEEDS)
def test_assign_classes_matches_reference(seed):
    tc, jc = twork.make_traffic_classes(SPEC), jwork.make_traffic_classes(
        SPEC)
    got = twork.assign_classes(64, tc, seed=seed)
    assert got == jwork.assign_classes(64, jc, seed=seed)
    assert set(got) <= {"interactive", "batch", "bulk"}
    assert twork.assign_classes(3, [], seed=seed) == ["", "", ""]
    zero = [twork.TrafficClass("a", weight=0.0),
            twork.TrafficClass("b", weight=0.0)]
    jzero = [jwork.TrafficClass("a", weight=0.0),
             jwork.TrafficClass("b", weight=0.0)]
    assert twork.assign_classes(8, zero, seed) == jwork.assign_classes(
        8, jzero, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_traces_match_reference(seed):
    assert twork.poisson_trace(50, seed=seed) == jwork.poisson_trace(
        50, seed=seed)
    assert twork.poisson_trace(20, seed=seed, betas=[30, 90]) \
        == jwork.poisson_trace(20, seed=seed, betas=[30, 90])
    assert twork.constant_rate_trace(30, 60.0, seed) \
        == jwork.constant_rate_trace(30, 60.0, seed)
    assert twork.flash_crowd_trace(40, seed=seed) \
        == jwork.flash_crowd_trace(40, seed=seed)
    with pytest.raises(ValueError):
        twork.flash_crowd_trace(4, peak_frac=1.5)


# ---------------------------------------------------------------------------
# the completion worker's collect waits
# ---------------------------------------------------------------------------


def test_completion_worker_records_collect_waits():
    reg = tobs.MetricsRegistry()
    with CompletionWorker(metrics=reg) as w:
        for i in range(5):
            w.submit(torch.full((2, 1), i), 0.0)
            host, dt = w.collect()
            assert host.tolist() == [[i], [i]] and dt >= 0.0
        snap = w.wait_snapshot()
    h = reg.histogram("pipeline.collect_wait_s")
    assert h.count == snap["count"] == 5 and h.min >= 0.0
    assert reg.counters() == {}
    with CompletionWorker() as w:
        w.submit(torch.zeros(1), 0.0)
        w.collect()
        assert w.wait_snapshot() == {}
