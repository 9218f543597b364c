"""Priority assignment (paper §IV-B, Eq. 2 / Eq. 3).

Notation per the paper: for task J with arrival r_J, priority point d_J,
uncertainty score u_J (predicted output length, tokens) and per-model
coefficients eta_f (s/output-token), phi_f (s/input-token):

  d_J   = r_J + phi_f * |J|      (empirical priority point; a
                                  user-specified deadline t_J replaces it)
  Eq. 2: p_J = 1 / (d_J - r_J - eta_f * u_J)                       (slack)
  Eq. 3: p_J = (1 - alpha * u_hat_J) / (d_J - r_J - eta_f * u_J)   (UP)

Normalization note (recorded in DESIGN.md §6): the paper sweeps alpha in
[0, 2] and calls alpha*u a "scaled uncertainty score"; with u in raw token
units (tens) the numerator would be dominated by -alpha*u for any alpha.
We therefore scale u_hat = u / u_scale (u_scale = a high quantile of the
training-set scores) inside Eq. 3, keeping raw token units everywhere
else (consolidation ratios, offload threshold tau).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

_EPS = 1e-6


def priority_point(arrival: float, input_len: float, phi: float,
                   deadline: Optional[float] = None,
                   xi: float = 2.0) -> float:
    """d_J: user deadline if present, else arrival + xi + phi_f * |J|.

    Adaptation note (DESIGN.md §6): the system-level batching window xi
    is added to the empirical priority point so that an unloaded system
    can actually meet it — with d = r + phi|J| alone every task would
    miss by construction, since dispatch waits up to xi for batch mates.
    """
    if deadline is not None:
        return deadline
    return arrival + xi + phi * input_len


def slack(d: float, r: float, u: float, eta: float) -> float:
    return d - r - eta * u


def eq2_priority(d: float, r: float, u: float, eta: float) -> float:
    """Eq. 2 — pure slack-based priority."""
    s = slack(d, r, u, eta)
    if abs(s) < _EPS:
        s = _EPS
    return 1.0 / s


def eq3_priority(d: float, r: float, u: float, eta: float, alpha: float,
                 u_scale: float) -> float:
    """Eq. 3 — Uncertainty-aware Prioritization (UP)."""
    s = slack(d, r, u, eta)
    if abs(s) < _EPS:
        s = _EPS
    u_hat = u / max(u_scale, _EPS)
    return (1.0 - alpha * u_hat) / s


@dataclasses.dataclass
class SimTask:
    """A task as seen by the scheduler: prediction + timing metadata."""
    task: object              # datagen.Task
    u: float                  # predicted uncertainty score (tokens)
    r: float                  # arrival time (s)
    d: float                  # priority point (s)
    input_len: float
    true_out_len: int         # persona ground truth (hidden from policy)
    u_hi: float = -1.0        # tail (P90) prediction; -1 -> mirror u
    p: float = 0.0            # assigned priority
    # filled by the simulator:
    start: float = -1.0
    finish: float = -1.0
    lane: str = ""

    def __post_init__(self):
        if self.u_hi < 0:
            self.u_hi = self.u

    @property
    def response_time(self) -> float:
        return self.finish - self.r

    @property
    def missed(self) -> bool:
        return self.finish > self.d
