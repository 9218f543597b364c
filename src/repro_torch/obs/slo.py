"""Windowed SLO monitor: per-traffic-class sliding-window latency
percentiles and attainment fractions (port of ``repro.obs.slo``).

``WindowedHistogram`` is a ring of epoch-bucketed ``Histogram``s
(``obs.metrics``): each sample lands in the histogram for its clock
epoch ``int(ts // window_s)``, and rotation is just dropping epochs
older than ``num_windows`` — O(buckets) thanks to the associative
``Histogram.merge``.  Expired epochs are folded into a lifetime
archive, so ``lifetime()`` always equals a histogram fed every sample
directly (tests/test_slo.py pins the bit-equality).  Rotation is
driven by the caller's virtual clock (``advance``/``record`` take
``ts``), so the engine and the simulator rotate on their own clocks —
window CONTENTS are wall-dependent by nature and excluded from the
parity view, while the attainment COUNTS under judgment-invariant
targets (``inf`` always attains, ``-1.0`` never — latencies are >= 0,
and 0.0 is a reachable boundary) are deterministic and parity-tested.

``SLOMonitor`` owns one ``WindowedHistogram`` + one attainment count
ring per (traffic class, metric) for the four latency metrics
``ttft``/``itl``/``e2e``/``queue_wait``, judged against per-class
``SLOSpec`` targets declared in the workload spec
(``core.workload.TrafficClass``).  Unknown or empty class names
resolve to ``default_class`` so classless traffic is still monitored.

This module is imported by ``core.workload`` (``SLOSpec`` is the
declaration type) — it must stay free of ``core`` imports.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .metrics import Histogram

#: the latency metrics the monitor windows, in reporting order
SLO_METRICS = ("ttft", "itl", "e2e", "queue_wait")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-class latency targets in seconds (``inf`` = unconstrained).

    ``ttft_s``/``itl_s`` are the paper-facing pair (RT-LM §V judges
    responsiveness on first-token and inter-token latency); ``e2e_s``
    and ``queue_wait_s`` round out the serving-side view.
    """

    ttft_s: float = math.inf
    itl_s: float = math.inf
    e2e_s: float = math.inf
    queue_wait_s: float = math.inf

    def target(self, metric: str) -> float:
        try:
            return getattr(self, metric + "_s")
        except AttributeError:
            raise KeyError(f"unknown SLO metric {metric!r}; "
                           f"expected one of {SLO_METRICS}") from None

    def to_json(self) -> Dict[str, float]:
        """Finite targets only — the trace-meta serialization."""
        return {m + "_s": self.target(m) for m in SLO_METRICS
                if math.isfinite(self.target(m))}

    @classmethod
    def from_json(cls, obj: Dict[str, float]) -> "SLOSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in obj.items() if k in known})


class WindowedHistogram:
    """Sliding-window histogram: a ring of per-epoch ``Histogram``s.

    ``record(ts, v)`` lands ``v`` in the epoch ``int(ts // window_s)``;
    ``advance(ts)`` folds epochs older than ``num_windows`` into the
    ``expired`` lifetime archive.  ``merged()`` is the live-window
    view, ``lifetime()`` the archive plus live windows — bit-equal to
    one histogram fed all samples, because ``Histogram.merge`` is
    associative.
    """

    __slots__ = ("window_s", "num_windows", "growth", "windows",
                 "expired", "_latest")

    def __init__(self, window_s: float = 60.0, num_windows: int = 5,
                 growth: float = Histogram.GROWTH) -> None:
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if num_windows < 1:
            raise ValueError(f"num_windows must be >= 1, got {num_windows}")
        self.window_s = float(window_s)
        self.num_windows = int(num_windows)
        self.growth = float(growth)
        self.windows: Dict[int, Histogram] = {}
        self.expired = Histogram(growth)
        self._latest: Optional[int] = None

    def _epoch(self, ts: float) -> int:
        return int(ts // self.window_s)

    def advance(self, ts: float) -> None:
        """Rotate to the epoch containing ``ts`` (monotone in ``ts``)."""
        epoch = self._epoch(ts)
        if self._latest is not None and epoch <= self._latest:
            return
        self._latest = epoch
        floor_epoch = epoch - self.num_windows + 1
        for k in [k for k in self.windows if k < floor_epoch]:
            self.expired.merge(self.windows.pop(k))

    def record(self, ts: float, v: float, n: int = 1) -> None:
        self.advance(ts)
        epoch = self._epoch(ts)
        h = self.windows.get(epoch)
        if h is None:
            h = self.windows[epoch] = Histogram(self.growth)
        h.record(v, n)

    # ------------------------------------------------------------------
    def merged(self) -> Histogram:
        """Fresh merge of the live (non-expired) windows."""
        h = Histogram(self.growth)
        for k in sorted(self.windows):
            h.merge(self.windows[k])
        return h

    def lifetime(self) -> Histogram:
        """Archive + live windows == one histogram fed every sample."""
        h = Histogram(self.growth)
        h.merge(self.expired)
        for k in sorted(self.windows):
            h.merge(self.windows[k])
        return h

    @property
    def count(self) -> int:
        return self.expired.count + sum(h.count
                                        for h in self.windows.values())

    def quantile(self, q: float) -> float:
        return self.merged().quantile(q)

    def snapshot(self) -> Dict:
        return {"windowed": self.merged().snapshot(),
                "lifetime": self.lifetime().snapshot()}


class _WindowCounts:
    """Ring of per-epoch ``[ok, total]`` attainment counts plus
    lifetime cumulative integers (the deterministic parity view)."""

    __slots__ = ("window_s", "num_windows", "windows", "ok", "total",
                 "_latest")

    def __init__(self, window_s: float = 60.0,
                 num_windows: int = 5) -> None:
        self.window_s = float(window_s)
        self.num_windows = int(num_windows)
        self.windows: Dict[int, List[int]] = {}
        self.ok = 0
        self.total = 0
        self._latest: Optional[int] = None

    def _epoch(self, ts: float) -> int:
        return int(ts // self.window_s)

    def advance(self, ts: float) -> None:
        epoch = self._epoch(ts)
        if self._latest is not None and epoch <= self._latest:
            return
        self._latest = epoch
        floor_epoch = epoch - self.num_windows + 1
        for k in [k for k in self.windows if k < floor_epoch]:
            del self.windows[k]

    def record(self, ts: float, ok: bool, n: int = 1) -> None:
        self.advance(ts)
        cell = self.windows.setdefault(self._epoch(ts), [0, 0])
        if ok:
            cell[0] += n
            self.ok += n
        cell[1] += n
        self.total += n

    def windowed(self) -> Tuple[int, int]:
        ok = sum(c[0] for c in self.windows.values())
        total = sum(c[1] for c in self.windows.values())
        return ok, total


def _frac(ok: int, total: int) -> float:
    """Attainment fraction; an idle window (no observations) counts as
    fully attained rather than NaN — the satellite-1 guard."""
    return ok / total if total else 1.0


class SLOMonitor:
    """Per-traffic-class windowed latency + SLO attainment tracker.

    One ``WindowedHistogram`` and one ``_WindowCounts`` per
    (class, metric); observations are judged ``value <= target`` at
    record time against the class's ``SLOSpec``, so attainment needs no
    retained samples.  ``parity_counters()`` exposes the cumulative
    integer counts — bit-for-bit engine-vs-sim comparable whenever the
    targets make the judgement deterministic (``inf``/``-1.0``).
    """

    def __init__(self, classes: Optional[Dict[str, SLOSpec]] = None, *,
                 window_s: float = 60.0, num_windows: int = 5,
                 default_class: str = "default",
                 growth: float = Histogram.GROWTH) -> None:
        self.classes: Dict[str, SLOSpec] = dict(classes or {})
        self.window_s = float(window_s)
        self.num_windows = int(num_windows)
        self.default_class = default_class
        self.growth = float(growth)
        self._hists: Dict[Tuple[str, str], WindowedHistogram] = {}
        self._counts: Dict[Tuple[str, str], _WindowCounts] = {}
        self.completions: Dict[str, int] = {}
        # per-replica split (multi-replica serving): cumulative
        # [ok, total] per (replica, class, metric) and completions per
        # (replica, class) — populated only when observations carry a
        # replica label, so single-replica runs are unchanged
        self._r_counts: Dict[Tuple[int, str, str], List[int]] = {}
        self.r_completions: Dict[Tuple[int, str], int] = {}

    # ------------------------------------------------------------------
    def resolve(self, cls: str) -> str:
        """Map empty/unknown class names onto a registered class."""
        if cls and cls in self.classes:
            return cls
        if self.default_class not in self.classes:
            self.classes[self.default_class] = SLOSpec()
        return self.default_class

    def _hist(self, cls: str, metric: str) -> WindowedHistogram:
        key = (cls, metric)
        h = self._hists.get(key)
        if h is None:
            h = self._hists[key] = WindowedHistogram(
                self.window_s, self.num_windows, self.growth)
        return h

    def _count(self, cls: str, metric: str) -> _WindowCounts:
        key = (cls, metric)
        c = self._counts.get(key)
        if c is None:
            c = self._counts[key] = _WindowCounts(self.window_s,
                                                  self.num_windows)
        return c

    # ------------------------------------------------------------------
    def observe(self, metric: str, cls: str, ts: float, value: float,
                n: int = 1, *, replica: Optional[int] = None) -> None:
        """Record ``n`` observations of ``value`` for (class, metric)
        at clock time ``ts`` and judge them against the class target.
        ``replica`` additionally lands the judgement in the per-replica
        cumulative split (multi-replica serving)."""
        if metric not in SLO_METRICS:
            raise KeyError(f"unknown SLO metric {metric!r}; "
                           f"expected one of {SLO_METRICS}")
        cls = self.resolve(cls)
        target = self.classes[cls].target(metric)
        self._hist(cls, metric).record(ts, value, n)
        self._count(cls, metric).record(ts, value <= target, n)
        if replica is not None:
            cell = self._r_counts.setdefault((replica, cls, metric),
                                             [0, 0])
            if value <= target:
                cell[0] += n
            cell[1] += n

    def complete(self, cls: str, *,
                 replica: Optional[int] = None) -> str:
        """Count a completion; returns the resolved class name."""
        cls = self.resolve(cls)
        self.completions[cls] = self.completions.get(cls, 0) + 1
        if replica is not None:
            key = (replica, cls)
            self.r_completions[key] = self.r_completions.get(key, 0) + 1
        return cls

    # ------------------------------------------------------------------
    def attainment(self) -> Dict[str, Dict]:
        """Cumulative per-class attainment + latency percentiles."""
        out: Dict[str, Dict] = {}
        for cls in sorted(self.classes):
            spec = self.classes[cls]
            row: Dict = {"completions": self.completions.get(cls, 0)}
            for m in SLO_METRICS:
                c = self._counts.get((cls, m))
                ok, total = (c.ok, c.total) if c is not None else (0, 0)
                h = self._hists.get((cls, m))
                row[m] = {"target_s": spec.target(m), "ok": ok,
                          "total": total, "frac": _frac(ok, total)}
                if h is not None:
                    row[m]["lifetime"] = h.lifetime().snapshot()
            out[cls] = row
        return out

    def windowed_attainment(self) -> Dict[str, Dict[str, float]]:
        """Live-window attainment fractions — the snapshot-event /
        ``health()`` view (idle windows report 1.0, never NaN)."""
        out: Dict[str, Dict[str, float]] = {}
        for cls in sorted(self.classes):
            row: Dict[str, float] = {}
            for m in SLO_METRICS:
                c = self._counts.get((cls, m))
                ok, total = c.windowed() if c is not None else (0, 0)
                row[m] = _frac(ok, total)
            out[cls] = row
        return out

    def parity_counters(self) -> Dict[str, int]:
        """Flat deterministic integer counters (engine-vs-sim view);
        per-replica splits appear as ``slo.r{N}.…`` keys when replica
        labels were recorded."""
        out: Dict[str, int] = {}
        for (cls, m) in sorted(self._counts):
            c = self._counts[(cls, m)]
            out[f"slo.{cls}.{m}.ok"] = c.ok
            out[f"slo.{cls}.{m}.total"] = c.total
        for cls in sorted(self.completions):
            out[f"slo.{cls}.completions"] = self.completions[cls]
        for (r, cls, m) in sorted(self._r_counts):
            ok, total = self._r_counts[(r, cls, m)]
            out[f"slo.r{r}.{cls}.{m}.ok"] = ok
            out[f"slo.r{r}.{cls}.{m}.total"] = total
        for (r, cls) in sorted(self.r_completions):
            out[f"slo.r{r}.{cls}.completions"] = \
                self.r_completions[(r, cls)]
        return out

    def replica_attainment(self) -> Dict[int, Dict[str, Dict]]:
        """Cumulative attainment fractions split by replica label —
        {} unless observations carried replica labels (R > 1 serving).
        Kept separate from ``attainment()`` (whose keys are class
        names) so existing consumers see no new keys."""
        out: Dict[int, Dict[str, Dict]] = {}
        for (r, cls, m) in sorted(self._r_counts):
            ok, total = self._r_counts[(r, cls, m)]
            row = out.setdefault(r, {}).setdefault(cls, {})
            row[m] = {"ok": ok, "total": total,
                      "frac": _frac(ok, total)}
        for (r, cls) in sorted(self.r_completions):
            out.setdefault(r, {}).setdefault(cls, {})["completions"] = \
                self.r_completions[(r, cls)]
        return out

    def lifetime_quantile(self, cls: str, metric: str,
                          q: float) -> float:
        """Lifetime (archive + live) quantile for (class, metric) —
        0.0 when nothing was observed."""
        h = self._hists.get((self.resolve(cls), metric))
        return h.lifetime().quantile(q) if h is not None else 0.0

    def targets_json(self) -> Dict[str, Dict[str, float]]:
        return {cls: spec.to_json()
                for cls, spec in sorted(self.classes.items())}
