"""Observability (port of ``repro.obs``; pure Python, no torch).

The telemetry layer under the serving stack's bit-parity discipline:
the port's engine (``ServingEngine(obs=...)``), the reference engine and
the reference simulator drive the SAME recorder and the SAME metrics
registry from the same decision points, so

  * the lifecycle EVENT stream (``obs.trace``) compares equal between
    engine and simulator up to wall-clock fields, and
  * every COUNTER both sides emit compares bit-for-bit,

exactly like the dispatch/budget traces in ``_result``/``SimResult``.
Recording is OFF by default (``obs=None`` everywhere): the serve loops
only touch the recorder behind ``if obs is not None`` guards, and the
no-obs serve path is bit-identical to the pre-obs engine
(tests/test_torch_obs_engine.py holds it).

Three pieces:

  * ``obs.trace``   — typed per-request lifecycle events + engine
    spans, JSONL sink, Chrome/Perfetto ``trace_event`` exporter;
  * ``obs.metrics`` — counters, gauges, log-bucketed streaming
    histograms with mergeable state and deterministic quantiles (the
    percentile substrate of ``_result``/``SimResult``);
  * ``obs.log``     — rate-limited warnings with countable fallback
    events (``fallback_events`` in serve results).

Failure-aware serving (``serving.faults``) adds the fault lifecycle
kinds to ``EVENT_KINDS`` — ``timeout``, ``shed``, ``retry``,
``failover``, ``replica_down``, ``replica_up``, ``dead_letter`` — and
the ``faults.*`` counters (``faults.timed_out``, ``faults.shed``,
``faults.retries``, ``faults.failovers``, ``faults.dead_lettered``,
``faults.replica_down``).  All of them sit
inside the parity view; runs without a fault plan emit none of them.

``Observability`` bundles one recorder + one registry per run; build
one with ``Observability()`` and pass it to ``ServingEngine(obs=...)``,
then export with ``obs.trace.to_jsonl(path)`` and inspect with
``scripts/trace_report.py`` (waterfall + percentile table) or
``ui.perfetto.dev`` (via ``obs.trace.export_perfetto``).
"""

from __future__ import annotations

import time
from typing import Optional

from .calibration import CalibrationLedger, u_bucket
from .log import FALLBACKS, RateLimitedLogger, fallback_count, warn_once
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      percentiles)
from .slo import (SLO_METRICS, SLOMonitor, SLOSpec, WindowedHistogram)
from .trace import (EVENT_KINDS, WALL_FIELDS, Event, RequestTimeline,
                    Span, TraceRecorder, timelines)

__all__ = [
    "CalibrationLedger", "Counter", "Event", "EVENT_KINDS", "FALLBACKS",
    "Gauge", "Histogram", "MetricsRegistry", "Observability",
    "RateLimitedLogger", "RequestTimeline", "SLO_METRICS", "SLOMonitor",
    "SLOSpec", "Span", "TraceRecorder", "WALL_FIELDS",
    "WindowedHistogram", "fallback_count", "percentiles", "timelines",
    "u_bucket", "warn_once",
]


class Observability:
    """One serve/simulation run's telemetry bundle.

    ``trace`` and ``metrics`` may individually be disabled (``None``);
    the convenience emitters no-op for a disabled piece, so call sites
    need only the single outer ``if obs is not None`` guard.

    ``overhead_s`` accumulates the wall-clock the ENGINE measured
    around its per-iteration emission blocks (``measure()``) — the
    measured-overhead guard: recording never touches the engine's
    virtual clock (events are emitted outside the timed device
    regions), and the measured wall cost is reported alongside the
    results so regressions are visible, not guessed.
    """

    def __init__(self, *, trace: bool = True, metrics: bool = True,
                 max_events: int = 1_000_000,
                 slo=None, calibration=None,
                 snapshot_every_steps: int = 0):
        self.trace: Optional[TraceRecorder] = \
            TraceRecorder(max_events) if trace else None
        self.metrics: Optional[MetricsRegistry] = \
            MetricsRegistry() if metrics else None
        self.overhead_s = 0.0
        # SLO monitor / calibration ledger / health snapshots
        # (all three default OFF so pre-PR construction is unchanged)
        if slo is True:
            slo = SLOMonitor()
        elif isinstance(slo, dict):
            slo = SLOMonitor(slo)
        self.slo: Optional[SLOMonitor] = slo
        if calibration is True:
            calibration = CalibrationLedger()
        self.calibration: Optional[CalibrationLedger] = calibration
        #: snapshot cadence in DECODE STEPS (the shared engine/sim
        #: iteration coordinate, so both sides snapshot at the same
        #: points); 0 disables snapshots
        self.snapshot_every_steps = int(snapshot_every_steps)
        self._snap_bucket: dict = {}   # per replica label (None=global)
        self.health_trace: list = []
        #: active replica id for multi-replica serving: while
        #: set (an int), every event/span gains a ``replica`` field,
        #: counters additionally bump an ``r{label}.``-prefixed mirror,
        #: and SLO observations are double-counted per replica — so one
        #: shared bundle records R replicas with per-replica parity
        #: views (``TraceRecorder.parity_events(replica=r)``).  ``None``
        #: (the default, and the R=1 serving path) leaves every stream
        #: byte-identical to single-replica recording.
        self.replica_label: Optional[int] = None
        if self.trace is not None and self.slo is not None \
                and self.slo.classes:
            self.trace.meta["slo"] = self.slo.targets_json()

    # ------------------------------------------------------------------
    # no-op-safe emitters — each self-times into ``overhead_s``
    # ------------------------------------------------------------------
    def event(self, kind: str, ts: float, task_id=None, step=None,
              **fields) -> None:
        if self.trace is not None:
            t0 = time.perf_counter()
            if self.replica_label is not None and "replica" not in fields:
                fields["replica"] = self.replica_label
            self.trace.event(kind, ts, task_id, step, **fields)
            self.overhead_s += time.perf_counter() - t0

    def span(self, name: str, ts: float, dur: float,
             track: str = "engine", **fields) -> None:
        if self.trace is not None:
            t0 = time.perf_counter()
            if self.replica_label is not None and "replica" not in fields:
                fields["replica"] = self.replica_label
            self.trace.span(name, ts, dur, track, **fields)
            self.overhead_s += time.perf_counter() - t0

    def counter_sample(self, name: str, ts: float, value: float) -> None:
        if self.trace is not None:
            t0 = time.perf_counter()
            self.trace.counter(name, ts, value)
            self.overhead_s += time.perf_counter() - t0

    def inc(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            t0 = time.perf_counter()
            self.metrics.counter(name).inc(n)
            if self.replica_label is not None:
                # per-replica counter mirror: pool totals stay in the
                # unprefixed counter, ``r{label}.*`` carries the split
                self.metrics.counter(
                    f"r{self.replica_label}.{name}").inc(n)
            self.overhead_s += time.perf_counter() - t0

    def gauge(self, name: str, value: float) -> None:
        if self.metrics is not None:
            t0 = time.perf_counter()
            self.metrics.gauge(name).set(value)
            self.overhead_s += time.perf_counter() - t0

    def observe(self, name: str, value: float, n: int = 1) -> None:
        if self.metrics is not None:
            t0 = time.perf_counter()
            self.metrics.histogram(name).record(value, n)
            self.overhead_s += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # SLO / calibration / snapshot emitters — same no-op-safe,
    # self-timed discipline as the trace/metrics emitters above
    # ------------------------------------------------------------------
    def slo_observe(self, metric: str, cls: str, ts: float,
                    value: float, n: int = 1) -> None:
        """Record a latency observation for (traffic class, metric)."""
        if self.slo is not None:
            t0 = time.perf_counter()
            self.slo.observe(metric, cls, ts, value, n,
                             replica=self.replica_label)
            self.overhead_s += time.perf_counter() - t0

    def complete_request(self, cls: str, ts: float, *, u: float,
                         out_len: int,
                         latency_s: Optional[float] = None) -> None:
        """One request finished: count the completion for its class,
        judge its end-to-end latency, and ledger u vs realization."""
        if self.slo is None and self.calibration is None:
            return
        t0 = time.perf_counter()
        if self.slo is not None:
            resolved = self.slo.complete(cls,
                                         replica=self.replica_label)
            if latency_s is not None:
                self.slo.observe("e2e", cls, ts, latency_s,
                                 replica=self.replica_label)
            if self.metrics is not None:
                self.metrics.counter(
                    "slo.completions." + resolved).inc()
                if self.replica_label is not None:
                    self.metrics.counter(
                        f"r{self.replica_label}.slo.completions."
                        + resolved).inc()
        if self.calibration is not None:
            self.calibration.record(u, out_len, latency_s)
        self.overhead_s += time.perf_counter() - t0

    def maybe_snapshot(self, ts: float, step: int, *, queue_depth: int,
                       active: int, kv_util: float,
                       wall: Optional[dict] = None) -> None:
        """Emit a periodic health ``snapshot`` event (and append it to
        ``health_trace``) every ``snapshot_every_steps`` decode steps.

        Cadence keys off ``step`` — not the clock — so the engine and
        the simulator snapshot at identical iterations; ``attainment``
        (wall latencies) and ``wall`` (engine-only extras) are in
        ``WALL_FIELDS`` and drop out of the parity view, leaving the
        deterministic observation vector (queue depth, active, KV
        utilization, drift, calibration count) to compare bit-for-bit.
        """
        if self.snapshot_every_steps <= 0:
            return
        # cadence state is per replica label (None = single-replica):
        # replica 3 crossing a bucket boundary must not suppress
        # replica 0's next snapshot when R replicas share the bundle
        bucket = step // self.snapshot_every_steps
        if bucket <= self._snap_bucket.get(self.replica_label, 0):
            return
        t0 = time.perf_counter()
        self._snap_bucket[self.replica_label] = bucket
        fields: dict = {"queue_depth": int(queue_depth),
                        "active": int(active),
                        "kv_util": float(kv_util)}
        if self.replica_label is not None:
            fields["replica"] = self.replica_label
        if self.calibration is not None:
            fields["drift"] = self.calibration.drift()
            fields["calibration_count"] = self.calibration.count
        if self.slo is not None:
            fields["attainment"] = self.slo.windowed_attainment()
        if wall:
            fields["wall"] = dict(wall)
        self.health_trace.append({"ts": float(ts), "step": int(step),
                                  **fields})
        if self.trace is not None:
            self.trace.event("snapshot", ts, None, step, **fields)
        self.overhead_s += time.perf_counter() - t0

    def health(self) -> dict:
        """Latest health snapshot ({} before the first one) — the
        observation vector a future auto-tuner/router polls."""
        return self.health_trace[-1] if self.health_trace else {}

    # ------------------------------------------------------------------
    def measure(self):
        """Context manager accumulating wall time into ``overhead_s``."""
        return _Measure(self)

    def event_count(self) -> int:
        return len(self.trace.events) if self.trace is not None else 0


class _Measure:
    __slots__ = ("obs", "t0")

    def __init__(self, obs: Observability):
        self.obs = obs

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.obs.overhead_s += time.perf_counter() - self.t0
        return False
