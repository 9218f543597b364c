"""Streaming log-bucketed histogram (copy of ``repro.obs.metrics.Histogram``).

The engine's result reports TTFT / ITL / queue-wait quantiles through this
class, as the reference engine and simulator do, so the port's tail metrics
are computed by the same deterministic quantile rule.  Samples land in
log-spaced buckets (relative width ``growth - 1``); ``quantile`` returns
the geometric midpoint of the bucket holding the target order statistic,
clamped to the observed ``[min, max]``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable


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
