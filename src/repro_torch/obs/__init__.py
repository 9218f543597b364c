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

Two clocks.  Events and the ``engine`` track's spans (``prefill.*``,
``decode.window``, ``bulk_batch``) are stamped with the engine's
virtual clock, which advances only by each dispatch's measured ``dt``.
``Phases`` adds two tracks on the wall clock (``time.perf_counter()``,
seconds from the first serve's start into the bundle): ``host``, the
serve loop's phases and the ``engine.iteration`` spans they tile, and
``device``, each dispatch's interval on the card from CUDA events on
the engine's stream.  A device interval runs from the dispatch's first
operation on the card (its graph's first node, an event captured into
the graph) to its readback's completion: the host's input copies and
graph launch before it are idle time, and a gap inside a replay counts
as busy.  ``trace.idle_by_phase`` charges the device's idle
seconds to the host phases.  With a profiler running, the phases are its
ranges too; the executables' own ``dispatch:<name>`` range is gone.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

from .calibration import CalibrationLedger, u_bucket
from .log import FALLBACKS, RateLimitedLogger, fallback_count, warn_once
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      percentiles)
from .slo import (SLO_METRICS, SLOMonitor, SLOSpec, WindowedHistogram)
from .trace import (EVENT_KINDS, WALL_FIELDS, Event, RequestTimeline,
                    Span, TraceRecorder, idle_by_phase, timelines)

# the reference's names; ``Phases`` and ``idle_by_phase`` (the wall-clock
# tracks) are the port's own and stay out of the mirrored list
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
        #: ``perf_counter`` at the first serve's start: the zero of the
        #: wall-clock tracks, shared by every serve into this bundle
        self.wall_origin: Optional[float] = None
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


_OFF = contextlib.nullcontext()


class Phases:
    """One serve's host phases and its dispatches' device intervals, on
    the wall clock.

    ``phases(name, **fields)`` is a context manager around one phase of
    the serve loop.  With a bundle whose trace is on (``obs``), the phase
    becomes a ``Span`` on the ``host`` track; with ``ranges`` (the
    profiler's ``record_function``, given when a profiler runs at the
    serve's start) it also opens a profiler range of the same name.  With
    neither, the call returns a shared no-op context: no span, no range,
    no event.  Phases do not nest: each starts where the one before it
    ended (the serve's start for the first), so the phases tile the serve
    and the Python between two of them is charged to the later one; the
    profiler's ranges open and close where the code does, so there that
    Python is outside every range.  ``next_iteration(**fields)`` ends the
    open ``engine.iteration`` span at the last phase's end and opens the
    next there, so each iteration's phases are its contiguous children.

    ``events`` (``torch.cuda.Event``, given with the trace on and on the
    card) turns on the device track.  ``anchor()`` records a timing event,
    waits for it and reads the wall clock beside it.  ``starts`` (a list,
    None without ``events``) collects where each dispatch starts on the
    card: the engine's graph executables append their graph's first node
    (``generate.GraphExecutable.starts``), and ``start()`` appends an
    event recorded on the current stream before eager work.
    ``device(name, end, **fields)``, once ``end`` (the readback's
    completion event) has completed, puts the interval from the first
    collected start to ``end`` on the ``device`` track as ``anchor_wall +
    elapsed_time(anchor, event)``, and empties ``starts``.  It reads the
    events at once: a graph re-records its event at its next replay.  An
    interval runs from the card's first operation of the dispatch to its
    last, so the host's input copies and graph launch before it are idle
    time, and the card's idle time inside it (a gap inside a replay)
    counts as busy.
    """

    __slots__ = ("obs", "ranges", "events", "on", "origin", "mark",
                 "starts", "_iter", "_anchor")

    def __init__(self, obs: Optional[Observability] = None, *,
                 ranges=None, events=None):
        now = time.perf_counter()
        self.obs = obs if obs is not None and obs.trace is not None \
            else None
        self.ranges = ranges
        self.events = events if self.obs is not None else None
        self.on = self.obs is not None or ranges is not None
        if self.obs is not None and self.obs.wall_origin is None:
            self.obs.wall_origin = now
        self.origin = self.obs.wall_origin if self.obs is not None else now
        self.mark = now               # the last phase's end
        self.starts: Optional[list] = [] if self.events is not None \
            else None
        self._iter = None             # (start, fields, profiler range)
        self._anchor = None           # (event, wall seconds)

    def __call__(self, name: str, **fields):
        if not self.on:
            return _OFF
        return _Phase(self, name, fields)

    def _span(self, name: str, t0: float, t1: float, track: str,
              fields: dict) -> None:
        self.obs.span(name, t0 - self.origin, t1 - t0, track, **fields)

    # -- iterations ----------------------------------------------------
    def next_iteration(self, **fields) -> None:
        """End the open iteration and open the next at the last phase's
        end."""
        if not self.on:
            return
        self.end_iteration()
        rf = None
        if self.ranges is not None:
            rf = self.ranges("engine.iteration")
            rf.__enter__()
        self._iter = (self.mark, fields, rf)

    def end_iteration(self) -> None:
        """End the open iteration, if any, at the last phase's end."""
        it, self._iter = self._iter, None
        if it is None:
            return
        t0, fields, rf = it
        if self.obs is not None:
            self._span("engine.iteration", t0, self.mark, "host", fields)
        if rf is not None:
            rf.__exit__(None, None, None)

    # -- the device track ----------------------------------------------
    def event(self):
        """A timing event recorded on the current stream (None without
        ``events``)."""
        if self.events is None:
            return None
        ev = self.events(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> None:
        """Mark the start of eager work that no graph marks."""
        if self.starts is not None:
            self.starts.append(self.event())

    def anchor(self) -> None:
        if self.events is not None:
            ev = self.event()
            ev.synchronize()
            self._anchor = (ev, time.perf_counter())

    def device(self, name: str, end, **fields) -> None:
        if not self.starts or end is None:
            return
        start = self.starts[0]
        self.starts.clear()
        with self.obs.measure():
            ev, wall = self._anchor
            t0 = wall + 1e-3 * ev.elapsed_time(start)
            self._span(name, t0, t0 + 1e-3 * start.elapsed_time(end),
                       "device", fields)


class _Phase:
    __slots__ = ("ph", "name", "fields", "t0", "rf")

    def __init__(self, ph: Phases, name: str, fields: dict):
        self.ph, self.name, self.fields = ph, name, fields
        self.rf = None

    def __enter__(self):
        ph = self.ph
        self.t0 = ph.mark
        if ph.ranges is not None:
            self.rf = ph.ranges(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        ph = self.ph
        ph.mark = t1 = time.perf_counter()
        if ph.obs is not None:
            ph._span(self.name, self.t0, t1, "host", self.fields)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False
