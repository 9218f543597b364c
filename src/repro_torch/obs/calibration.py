"""Uncertainty-predictor calibration ledger.

RT-LM schedules on u = m_theta(RULEGEN(J)), the predicted output
length.  The ledger measures, online, how good that prediction is: at
each ``complete`` event the caller records ``(u, realized output
length, realized latency)`` and the ledger maintains

  * streaming MAE / signed bias of ``u - out_len``,
  * per-u-bucket reliability rows (power-of-two u buckets, each with a
    predicted and a realized ``Histogram`` — the reliability-diagram
    substrate: predicted quantile vs realized quantile per bucket),
  * a windowed drift score: total-variation distance between the
    recent ``|error|`` distribution and a baseline frozen after the
    first ``baseline_n`` completions, over the existing log-bucket
    representation.

Drift windows are COUNT-based (epoch = completions // drift_window),
not time-based: the engine and the simulator complete the same
requests in the same order in the parity tests, so every quantity here
except the realized-latency histogram is bit-for-bit deterministic —
``parity()`` is the engine-vs-sim comparison view.  Latency (wall) is
kept in a separate histogram that never feeds the drift score.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from .metrics import Histogram

#: dict key for the zero/non-positive bucket in drift distributions
_ZERO = "zero"


def u_bucket(u: float) -> int:
    """Power-of-two bucket index for a predicted length: ``-1`` for
    ``u < 1``, else ``floor(log2(u))`` (bucket ``k`` covers
    ``[2**k, 2**(k+1))``)."""
    if u < 1.0:
        return -1
    return int(math.floor(math.log2(u)))


class _Row:
    """One u bucket's reliability state."""

    __slots__ = ("n", "u_sum", "real_sum", "pred", "real")

    def __init__(self, growth: float) -> None:
        self.n = 0
        self.u_sum = 0.0
        self.real_sum = 0.0
        self.pred = Histogram(growth)
        self.real = Histogram(growth)


class CalibrationLedger:
    """Streaming u-vs-realized calibration state (see module doc)."""

    def __init__(self, *, growth: float = Histogram.GROWTH,
                 drift_window: int = 64, drift_windows: int = 4,
                 baseline_n: Optional[int] = None) -> None:
        if drift_window < 1:
            raise ValueError(f"drift_window must be >= 1, "
                             f"got {drift_window}")
        if drift_windows < 1:
            raise ValueError(f"drift_windows must be >= 1, "
                             f"got {drift_windows}")
        self.growth = float(growth)
        self.drift_window = int(drift_window)
        self.drift_windows = int(drift_windows)
        self.baseline_n = int(baseline_n if baseline_n is not None
                              else drift_window)
        self.count = 0
        self.err_sum = 0.0
        self.abs_err_sum = 0.0
        self.rows: Dict[int, _Row] = {}
        #: count-epoch -> |error| histogram (the recent-window ring)
        self._err_windows: Dict[int, Histogram] = {}
        #: |error| histogram frozen once ``count == baseline_n``
        self.baseline = Histogram(growth)
        self.baseline_frozen = False
        #: realized latency — wall-only, excluded from drift and parity
        self.latency = Histogram(growth)

    # ------------------------------------------------------------------
    def record(self, u: float, out_len: int,
               latency_s: Optional[float] = None) -> None:
        """Record one completion's prediction vs realization."""
        u = float(u)
        out_len = int(out_len)
        err = u - out_len
        epoch = self.count // self.drift_window
        self.count += 1
        self.err_sum += err
        self.abs_err_sum += abs(err)

        row = self.rows.get(u_bucket(u))
        if row is None:
            row = self.rows[u_bucket(u)] = _Row(self.growth)
        row.n += 1
        row.u_sum += u
        row.real_sum += float(out_len)
        row.pred.record(u)
        row.real.record(float(out_len))

        h = self._err_windows.get(epoch)
        if h is None:
            h = self._err_windows[epoch] = Histogram(self.growth)
            floor_epoch = epoch - self.drift_windows + 1
            for k in [k for k in self._err_windows if k < floor_epoch]:
                del self._err_windows[k]
        h.record(abs(err))
        if not self.baseline_frozen:
            self.baseline.record(abs(err))
            if self.count >= self.baseline_n:
                self.baseline_frozen = True

        if latency_s is not None:
            self.latency.record(float(latency_s))

    # ------------------------------------------------------------------
    @property
    def mae(self) -> float:
        return self.abs_err_sum / self.count if self.count else 0.0

    @property
    def bias(self) -> float:
        return self.err_sum / self.count if self.count else 0.0

    # ------------------------------------------------------------------
    @staticmethod
    def _dist(h: Histogram) -> Dict:
        if h.count == 0:
            return {}
        out = {k: n / h.count for k, n in h.buckets.items()}
        if h.zero_count:
            out[_ZERO] = h.zero_count / h.count
        return out

    def _recent(self) -> Histogram:
        h = Histogram(self.growth)
        for k in sorted(self._err_windows):
            h.merge(self._err_windows[k])
        return h

    def drift(self) -> float:
        """Total-variation distance in [0, 1] between the recent
        ``|error|`` distribution and the frozen baseline; 0.0 until the
        baseline is frozen (count-deterministic, hence parity-safe)."""
        if not self.baseline_frozen:
            return 0.0
        p = self._dist(self._recent())
        q = self._dist(self.baseline)
        if not p or not q:
            return 0.0
        keys = set(p) | set(q)
        return 0.5 * sum(abs(p.get(k, 0.0) - q.get(k, 0.0))
                         for k in keys)

    # ------------------------------------------------------------------
    def reliability(self) -> List[Dict]:
        """Per-u-bucket rows, ascending by bucket — the reliability
        diagram's data (predicted vs realized central quantiles)."""
        out: List[Dict] = []
        for k in sorted(self.rows):
            row = self.rows[k]
            out.append({
                "u_lo": 0.0 if k < 0 else float(2 ** k),
                "u_hi": 1.0 if k < 0 else float(2 ** (k + 1)),
                "n": row.n,
                "u_mean": row.u_sum / row.n,
                "u_p50": row.pred.quantile(0.5),
                "real_mean": row.real_sum / row.n,
                "real_p50": row.real.quantile(0.5),
                "real_p90": row.real.quantile(0.9),
            })
        return out

    def summary(self) -> Dict:
        """The ``_result``/``SimResult``-facing view."""
        return {"count": self.count, "mae": self.mae, "bias": self.bias,
                "drift": self.drift(),
                "reliability": self.reliability(),
                "latency": self.latency.snapshot()}

    def parity(self) -> Dict:
        """Deterministic engine-vs-sim comparison view (no latency)."""
        return {"count": self.count, "err_sum": self.err_sum,
                "abs_err_sum": self.abs_err_sum, "drift": self.drift(),
                "bucket_counts": {k: r.n
                                  for k, r in sorted(self.rows.items())}}
