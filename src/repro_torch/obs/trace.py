"""Request-lifecycle event/span recorder with Perfetto export (port of
``repro.obs.trace``).

Typed per-request lifecycle events flow through one ``TraceRecorder``:

    enqueue -> admit | reject | offload
            -> prefix_hit? -> prefill_chunk* -> first_token
            -> (decode_window / token)* -> complete -> evict

Each event is stamped with the engine's virtual clock (``ts``), the
iteration index (``step`` — decode steps executed so far, the shared
engine/sim iteration coordinate), and structured fields (slot,
uncertainty score, KV blocks held, dispatch shape key, ...).  The real
engine additionally records per-iteration SPANS (wall-clock
launch→readback durations of the prefill and decode-window dispatches)
and counter samples (KV-pool utilization) for the Perfetto timeline.

Parity discipline: ``ServingEngine`` and ``simulate_continuous`` emit
the SAME event stream from the same decision points, so
``parity_events()`` — every event minus its wall-clock fields (``ts``
and the per-token ``times``) — compares with ``==`` between engine and
simulator whenever their scheduling decisions agree
(tests/test_torch_obs_engine.py holds the port to both).  Spans and
counter samples are wall-clock-only by construction and excluded.

Exports (zero dependencies beyond the stdlib):

  * ``to_jsonl`` / ``load_jsonl`` — one JSON object per line, lossless
    round-trip, the capture format ``scripts/trace_report.py`` reads;
  * ``to_perfetto`` — Chrome ``trace_event`` JSON (open in
    ``ui.perfetto.dev`` or ``chrome://tracing``): one track per
    request (derived queued/prefill/decode phase spans + instants),
    one engine track (iteration spans), counter tracks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

#: wall-clock field names excluded from the engine-vs-sim parity view
#: (``attainment`` aggregates wall latencies; ``wall`` is the
#: engine-only extras dict on ``snapshot`` events)
WALL_FIELDS = frozenset({"ts", "dur", "times", "attainment", "wall"})

#: the typed event vocabulary (trace_report validates against it);
#: the fault/failure kinds (serving.faults) only appear when a run is
#: given a FaultPlan — unfaulted streams stay byte-identical to pre-
#: fault traces
EVENT_KINDS = frozenset({
    "enqueue", "admit", "reject", "offload", "prefix_hit", "exec_cache",
    "prefill_chunk", "first_token", "decode_window", "token", "evict",
    "complete", "bulk_batch", "snapshot", "route",
    "timeout", "shed", "retry", "failover", "replica_down", "replica_up",
    "dead_letter",
})


@dataclasses.dataclass
class Event:
    """One lifecycle event.  ``fields`` holds the structured payload;
    wall-clock members of it (``WALL_FIELDS``) are excluded from
    parity comparison alongside ``ts``."""

    kind: str
    ts: float
    task_id: Optional[int] = None
    step: Optional[int] = None
    fields: Dict = dataclasses.field(default_factory=dict)

    def parity_key(self) -> Tuple:
        payload = tuple(sorted(
            (k, _freeze(v)) for k, v in self.fields.items()
            if k not in WALL_FIELDS))
        return (self.kind, self.task_id, self.step, payload)

    def to_json(self) -> Dict:
        return {"type": "event", "kind": self.kind, "ts": self.ts,
                "task_id": self.task_id, "step": self.step,
                **self.fields}


@dataclasses.dataclass
class Span:
    """One wall-clock span on an engine-side track (iteration phases:
    prefill launch, decode window, bulk batch)."""

    name: str
    ts: float                       # span start (engine clock, seconds)
    dur: float                      # duration (seconds)
    track: str = "engine"
    fields: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"type": "span", "name": self.name, "ts": self.ts,
                "dur": self.dur, "track": self.track, **self.fields}


def _freeze(v):
    """Hashable, order-stable view of a field value for parity keys."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


class TraceRecorder:
    """Append-only recorder with a bounded-memory guard.

    ``max_events`` caps retained events (spans and counter samples ride
    the same budget); past the cap, recording drops and counts — the
    guard that keeps tracing safe to leave on for million-request
    simulations.  ``dropped`` > 0 means the trace is a prefix, not a
    sample: exports stay valid, percentile tables note the truncation.
    """

    def __init__(self, max_events: int = 1_000_000):
        self.max_events = max_events
        self.events: List[Event] = []
        self.spans: List[Span] = []
        self.counters: List[Tuple[str, float, float]] = []  # name, ts, v
        self.dropped = 0
        #: run-level metadata (e.g. declared SLO targets) — written as
        #: a leading ``{"type": "meta", ...}`` JSONL line when nonempty
        self.meta: Dict = {}

    # ------------------------------------------------------------------
    def _budget(self) -> bool:
        if (len(self.events) + len(self.spans) + len(self.counters)
                >= self.max_events):
            self.dropped += 1
            return False
        return True

    def event(self, kind: str, ts: float, task_id: Optional[int] = None,
              step: Optional[int] = None, **fields) -> None:
        if self._budget():
            self.events.append(Event(kind=kind, ts=float(ts),
                                     task_id=task_id, step=step,
                                     fields=fields))

    def span(self, name: str, ts: float, dur: float,
             track: str = "engine", **fields) -> None:
        if self._budget():
            self.spans.append(Span(name=name, ts=float(ts),
                                   dur=float(dur), track=track,
                                   fields=fields))

    def counter(self, name: str, ts: float, value: float) -> None:
        if self._budget():
            self.counters.append((name, float(ts), float(value)))

    # ------------------------------------------------------------------
    def parity_events(self, replica=None) -> List[Tuple]:
        """The event stream minus wall-clock fields — the engine-vs-sim
        comparison view (spans/counters are wall-only and excluded).

        ``replica`` — restrict to one replica's substream of a
        multi-replica run (events whose ``replica`` field matches),
        excluding front-end ``route`` events: the router emits those
        before the replica does any work, so they belong to the pool
        view (compare them as ``[e for e in parity_events() if
        e[0] == "route"]``), not to any one replica's causal order.
        """
        if replica is None:
            return [e.parity_key() for e in self.events]
        return [e.parity_key() for e in self.events
                if e.kind != "route"
                and e.fields.get("replica") == replica]

    def task_ids(self) -> List[int]:
        seen: Dict[int, None] = {}
        for e in self.events:
            if e.task_id is not None:
                seen.setdefault(e.task_id)
        return list(seen)

    # ------------------------------------------------------------------
    # JSONL sink / source
    # ------------------------------------------------------------------
    def to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            if self.meta:
                f.write(json.dumps({"type": "meta", **self.meta}) + "\n")
            for e in self.events:
                f.write(json.dumps(e.to_json()) + "\n")
            for s in self.spans:
                f.write(json.dumps(s.to_json()) + "\n")
            for name, ts, v in self.counters:
                f.write(json.dumps({"type": "counter", "name": name,
                                    "ts": ts, "value": v}) + "\n")
        return path

    @classmethod
    def load_jsonl(cls, path: str) -> "TraceRecorder":
        rec = cls(max_events=1 << 62)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                typ = obj.pop("type", "event")
                if typ == "meta":
                    rec.meta.update(obj)
                elif typ == "span":
                    rec.span(obj.pop("name"), obj.pop("ts"),
                             obj.pop("dur"), obj.pop("track", "engine"),
                             **obj)
                elif typ == "counter":
                    rec.counter(obj["name"], obj["ts"], obj["value"])
                else:
                    rec.event(obj.pop("kind"), obj.pop("ts"),
                              obj.pop("task_id", None),
                              obj.pop("step", None), **obj)
        return rec

    # ------------------------------------------------------------------
    # Chrome/Perfetto trace_event export
    # ------------------------------------------------------------------
    _PID_REQUESTS = 1
    _PID_ENGINE = 2

    def to_perfetto(self) -> Dict:
        """Chrome ``trace_event`` JSON object (dump with ``json.dump``
        or via ``export_perfetto``).  Timestamps are microseconds.

        Per-request tracks (pid 1, tid = task id) carry derived phase
        spans — ``queued`` (enqueue→admit), ``prefill`` (admit→first
        token), ``decode`` (first token→complete) — plus instants for
        chunk launches, prefix hits, rejections and eviction.  The
        engine track (pid 2) carries the recorded wall-clock iteration
        spans; counter samples become ``C`` events.
        """
        us = 1e6
        out: List[Dict] = [
            {"ph": "M", "name": "process_name", "pid": self._PID_REQUESTS,
             "args": {"name": "requests"}},
            {"ph": "M", "name": "process_name", "pid": self._PID_ENGINE,
             "args": {"name": "engine"}},
        ]
        by_task: Dict[int, Dict[str, Event]] = {}
        for e in self.events:
            if e.task_id is None:
                continue
            slots = by_task.setdefault(e.task_id, {})
            # first occurrence wins for phase anchors
            slots.setdefault(e.kind, e)
        for tid, anchors in by_task.items():
            out.append({"ph": "M", "name": "thread_name",
                        "pid": self._PID_REQUESTS, "tid": tid,
                        "args": {"name": f"req {tid}"}})
            enq = anchors.get("enqueue")
            admit = anchors.get("admit") or anchors.get("offload")
            first = anchors.get("first_token")
            comp = anchors.get("complete")
            phases = [("queued", enq, admit), ("prefill", admit, first),
                      ("decode", first, comp)]
            for name, a, b in phases:
                if a is None or b is None:
                    continue
                out.append({"name": name, "ph": "X",
                            "pid": self._PID_REQUESTS, "tid": tid,
                            "ts": a.ts * us,
                            "dur": max(b.ts - a.ts, 0.0) * us,
                            "args": {**a.fields}})
        instant_kinds = {"prefill_chunk", "prefix_hit", "reject",
                         "evict", "exec_cache", "first_token"}
        for e in self.events:
            if e.kind not in instant_kinds or e.task_id is None:
                continue
            out.append({"name": e.kind, "ph": "i", "s": "t",
                        "pid": self._PID_REQUESTS, "tid": e.task_id,
                        "ts": e.ts * us,
                        "args": {"step": e.step,
                                 **{k: v for k, v in e.fields.items()
                                    if k not in WALL_FIELDS}}})
        for s in self.spans:
            out.append({"name": s.name, "ph": "X",
                        "pid": self._PID_ENGINE, "tid": 0,
                        "ts": s.ts * us, "dur": s.dur * us,
                        "args": dict(s.fields)})
        for name, ts, v in self.counters:
            out.append({"name": name, "ph": "C",
                        "pid": self._PID_ENGINE, "ts": ts * us,
                        "args": {"value": v}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_perfetto(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)
        return path


# ---------------------------------------------------------------------------
# trace-derived request timelines (trace_report + the acceptance test)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RequestTimeline:
    """Per-request reconstruction from a trace's event stream."""

    task_id: int
    arrival: float = -1.0
    admit_ts: float = -1.0
    first_token_ts: float = -1.0
    complete_ts: float = -1.0
    token_times: List[float] = dataclasses.field(default_factory=list)
    chunks: int = 0
    rejected: int = 0
    cls: str = ""                   # traffic class (enqueue ``cls``)
    u: float = -1.0                 # predicted length (admit ``u``)
    out_len: int = -1               # realized length (complete)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_ts < 0 or self.arrival < 0:
            return None
        return self.first_token_ts - self.arrival

    @property
    def e2e(self) -> Optional[float]:
        if self.complete_ts < 0 or self.arrival < 0:
            return None
        return self.complete_ts - self.arrival

    @property
    def queue_wait(self) -> Optional[float]:
        if self.admit_ts < 0 or self.arrival < 0:
            return None
        return self.admit_ts - self.arrival

    @property
    def itls(self) -> List[float]:
        times = self.token_times
        if self.first_token_ts >= 0:
            times = [self.first_token_ts] + times
        return [b - a for a, b in zip(times, times[1:])]


def timelines(rec: TraceRecorder) -> Dict[int, RequestTimeline]:
    """Fold a recorder's event stream into per-request timelines —
    exactly the data ``_result`` computes TTFT/ITL from, so the
    trace-reconstructed percentiles match the serve results."""
    out: Dict[int, RequestTimeline] = {}

    def tl(tid: int) -> RequestTimeline:
        t = out.get(tid)
        if t is None:
            t = out[tid] = RequestTimeline(task_id=tid)
        return t

    for e in rec.events:
        tid = e.task_id
        if tid is None:
            continue
        t = tl(tid)
        if e.kind == "enqueue":
            t.arrival = e.ts
            t.cls = e.fields.get("cls", t.cls)
        elif e.kind == "admit" and t.admit_ts < 0:
            t.admit_ts = e.ts
            t.u = float(e.fields.get("u", t.u))
        elif e.kind == "first_token":
            t.first_token_ts = e.ts
        elif e.kind == "token":
            t.token_times.append(e.ts)
        elif e.kind == "complete":
            t.complete_ts = e.ts
            t.out_len = int(e.fields.get("out_len", t.out_len))
        elif e.kind == "prefill_chunk":
            t.chunks += 1
        elif e.kind == "reject":
            t.rejected += 1
    return out
