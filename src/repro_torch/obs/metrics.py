"""Streaming metrics: counters, gauges, log-bucketed histograms (port of
``repro.obs.metrics``).

The registry is the engine/simulator-shared half of the observability
substrate (``obs``): both sides drive the same classes with the
same deterministic quantities (admission counts, chunk budget fills,
eviction-lag depths), so a counter — and even a histogram fed
bit-identical samples — compares bit-for-bit in the engine-vs-sim
parity tests, exactly like the dispatch counters in
``ServingEngine._result`` / ``SimResult``.

``Histogram`` is the replacement for the pooled-list percentile math
that used to live in ``_result``/``SimResult``: samples land in
log-spaced buckets (relative width ``growth - 1``), state is a sparse
``bucket index -> count`` dict that merges associatively, and
``quantile`` returns a deterministic estimate — the geometric midpoint
of the bucket holding the target order statistic, clamped to the exact
observed ``[min, max]`` — so a million-request simulation keeps O(num
buckets) state instead of every inter-token latency, while any
percentile stays within one bucket's relative width of the exact order
statistic (tests/test_obs.py pins the bound).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> "Counter":
        self.value += other.value
        return self

    def snapshot(self):
        return self.value


class Gauge:
    """Last-written value plus running max/mean of every ``set``."""

    __slots__ = ("value", "max", "total", "n")

    def __init__(self) -> None:
        self.value = 0.0
        self.max = 0.0
        self.total = 0.0
        self.n = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.max = v if self.n == 0 else max(self.max, v)
        self.total += v
        self.n += 1

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def merge(self, other: "Gauge") -> "Gauge":
        if other.n:
            self.value = other.value          # other wrote last
            self.max = other.max if self.n == 0 else max(self.max,
                                                         other.max)
            self.total += other.total
            self.n += other.n
        return self

    def snapshot(self):
        return {"last": self.value, "max": self.max, "mean": self.mean}


class Histogram:
    """Log-bucketed streaming histogram with deterministic quantiles.

    Bucket ``k`` covers ``[growth**k, growth**(k+1))``; non-positive
    samples land in a dedicated zero bucket (latency metrics may
    legitimately record 0.0 — e.g. two tokens stamped at the same
    virtual-clock instant).  State is mergeable and associative:
    ``merge`` adds bucket counts, takes min/max of extremes, and the
    resulting quantiles are identical whichever way a set of shards is
    folded together (tests/test_obs.py::test_histogram_merge_*).

    ``quantile(q)`` locates the bucket containing order statistic
    ``ceil(q * (count - 1))`` (0-indexed) and returns its geometric
    midpoint clamped to the observed ``[min, max]`` — within a factor
    ``sqrt(growth)`` of that order statistic, i.e. a relative error of
    at most ``sqrt(growth) - 1`` (~2.5% at the default growth).
    """

    __slots__ = ("growth", "_log_g", "buckets", "zero_count", "count",
                 "total", "min", "max")

    #: default bucket growth: 5% relative bucket width
    GROWTH = 1.05

    #: bucket index for infinite observations — timed-out / shed
    #: requests record an ``inf`` e2e latency (a deadline miss never
    #: resolves), which must land in a dedicated overflow bucket
    #: rather than overflow the log-bucket index
    OVERFLOW_BUCKET = 1 << 62

    def __init__(self, growth: float = GROWTH) -> None:
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ------------------------------------------------------------------
    def _index(self, v: float) -> int:
        if math.isinf(v):
            return self.OVERFLOW_BUCKET
        return int(math.floor(math.log(v) / self._log_g))

    def record(self, v: float, n: int = 1) -> None:
        v = float(v)
        if n < 1:
            return
        if v > 0.0:
            k = self._index(v)
            self.buckets[k] = self.buckets.get(k, 0) + n
        else:
            self.zero_count += n
        self.count += n
        self.total += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def record_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.record(v)

    # ------------------------------------------------------------------
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Deterministic quantile estimate (0.0 on an empty histogram).

        Rank rule: the 0-indexed order statistic ``ceil(q * (n - 1))``
        — the upper neighbour of numpy's linear-interpolation pair, so
        the estimate brackets ``np.quantile`` from above within one
        bucket's width.

        Edge cases are pinned by tests/test_slo.py: an out-of-range
        ``q`` raises even on an empty histogram, an empty histogram
        returns exactly 0.0 (never NaN — idle SLO windows rotate
        through here), and a single-observation histogram returns that
        observation exactly (the ``[min, max]`` clamp collapses).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = math.ceil(q * (self.count - 1))
        if rank < self.zero_count:
            return max(0.0, self.min)
        seen = self.zero_count
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if rank < seen:
                rep = (math.inf if k >= self.OVERFLOW_BUCKET
                       else math.exp((k + 0.5) * self._log_g))
                return min(max(rep, self.min), self.max)
        return self.max                      # pragma: no cover - guard

    def quantiles(self, qs: Iterable[float]) -> Dict[float, float]:
        return {q: self.quantile(q) for q in qs}

    # ------------------------------------------------------------------
    def merge(self, other: "Histogram") -> "Histogram":
        if abs(other.growth - self.growth) > 1e-12:
            raise ValueError("cannot merge histograms with different "
                             f"growth ({self.growth} vs {other.growth})")
        for k, n in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def snapshot(self):
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    One registry per serve/simulation run.  ``merge`` folds another
    run's registry in (same-name instruments must be the same kind) —
    the fan-in primitive for sharded or repeated runs.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str,
                  growth: float = Histogram.GROWTH) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(growth)
        return h

    # ------------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        """Counter name -> value (the engine-vs-sim parity view: every
        counter both sides emit is fed deterministic quantities, so
        this dict compares with ``==``)."""
        return {k: c.value for k, c in sorted(self._counters.items())}

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for k, c in other._counters.items():
            self.counter(k).merge(c)
        for k, g in other._gauges.items():
            self.gauge(k).merge(g)
        for k, h in other._hists.items():
            self.histogram(k, h.growth).merge(h)
        return self

    def snapshot(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for k, c in sorted(self._counters.items()):
            out[k] = {"type": "counter", "value": c.snapshot()}
        for k, g in sorted(self._gauges.items()):
            out[k] = {"type": "gauge", **g.snapshot()}
        for k, h in sorted(self._hists.items()):
            out[k] = {"type": "histogram", **h.snapshot()}
        return out


def percentiles(values, registry: Optional[MetricsRegistry] = None,
                name: str = "", growth: float = Histogram.GROWTH
                ) -> Histogram:
    """Fold ``values`` into a (possibly registry-owned) histogram —
    the one-liner ``_result``/``SimResult`` use to rebase their
    percentile fields onto bucketed state."""
    h = registry.histogram(name, growth) if registry is not None \
        else Histogram(growth)
    h.record_many(values)
    return h
