"""Poisson workload generation (paper §V-A Workload setup; port of
``repro.core.workload``).

Inter-arrival times are sampled from an exponential distribution whose
rate evolves minute-by-minute through beta = 10..150 queries/min (the
paper iterates integer beta values, one minute each, light load to
high-traffic peak).  A wait-time interval xi (=2 s) groups arrivals for
batch processing — the simulator implements xi as its dispatch window.

Traffic classes: a workload spec may declare named classes with
per-class SLO targets (``slo={"ttft_s": ..., "itl_s": ...}``) that the
windowed SLO monitor (``obs.slo``) judges attainment against.
``SLOSpec`` lives in ``obs.slo`` (obs must stay importable without
``core``; this import direction is the safe one).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from ..obs.slo import SLOSpec


def poisson_trace(n_tasks: int, *, beta_min: int = 10, beta_max: int = 150,
                  seed: int = 0,
                  betas: Optional[Sequence[int]] = None) -> List[float]:
    """Arrival times (s) for n_tasks, beta evolving one minute per value."""
    rng = np.random.default_rng(seed)
    if betas is None:
        betas = list(range(beta_min, beta_max + 1, 10))
    arrivals: List[float] = []
    t = 0.0
    minute_end = 60.0
    bi = 0
    while len(arrivals) < n_tasks:
        beta = betas[min(bi, len(betas) - 1)]
        mu = 60.0 / beta                       # mean inter-arrival (s)
        t = t + rng.exponential(mu)
        while t >= minute_end:
            minute_end += 60.0
            bi += 1
        arrivals.append(t)
    return arrivals


def constant_rate_trace(n_tasks: int, beta: float, seed: int = 0
                        ) -> List[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(60.0 / beta, size=n_tasks)
    return list(np.cumsum(gaps))


def flash_crowd_trace(n_tasks: int, *, base_beta: float = 30.0,
                      peak_beta: float = 300.0,
                      peak_frac: float = 0.25,
                      seed: int = 0) -> List[float]:
    """Arrival times (s) with a flash crowd in the middle of the trace:
    a baseline Poisson stream at ``base_beta`` queries/min whose middle
    ``peak_frac`` of requests arrive at ``peak_beta`` instead — the
    sudden burst that separates placement policies (a load-oblivious
    router keeps hashing the burst uniformly; a load/uncertainty-aware
    one drains it around the backlog).  Deterministic per seed."""
    if not 0.0 <= peak_frac <= 1.0:
        raise ValueError(f"peak_frac must be in [0, 1], got {peak_frac}")
    rng = np.random.default_rng(seed)
    n_peak = int(n_tasks * peak_frac)
    n_base = n_tasks - n_peak
    lead = n_base // 2
    rates = ([base_beta] * lead + [peak_beta] * n_peak
             + [base_beta] * (n_tasks - lead - n_peak))
    gaps = [rng.exponential(60.0 / rates[i]) for i in range(n_tasks)]
    return list(np.cumsum(gaps))


# ---------------------------------------------------------------------------
# traffic classes with per-class SLO targets
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One named slice of the workload with its latency SLO.

    ``weight`` is the relative arrival share used by
    ``assign_classes``; ``max_new_tokens`` optionally caps generation
    for the class (interactive traffic tends to be short); ``bulk``
    marks the class as low-priority batch traffic that the
    multi-replica router confines to its bulk replica slice
    (the reference's ``serving.router.Router(bulk_classes=...)``, not
    ported yet — see
    ``bulk_class_names``).
    """

    name: str
    slo: SLOSpec = SLOSpec()
    weight: float = 1.0
    max_new_tokens: Optional[int] = None
    bulk: bool = False


def make_traffic_classes(spec: Mapping[str, Mapping]
                         ) -> List[TrafficClass]:
    """Build classes from the declaration form the workload spec
    uses::

        make_traffic_classes({
            "interactive": {"slo": {"ttft_s": 0.5, "itl_s": 0.1},
                            "weight": 3.0},
            "batch": {"slo": {"e2e_s": 60.0}},
        })

    A bare mapping of target names is also accepted as the ``slo``
    shorthand (``{"interactive": {"ttft_s": 0.5}}``).
    """
    classes: List[TrafficClass] = []
    for name, cfg in spec.items():
        cfg = dict(cfg)
        slo = cfg.pop("slo", None)
        if slo is None:
            # shorthand: the cfg itself is the target mapping
            slo = {k: cfg.pop(k) for k in list(cfg)
                   if k.endswith("_s")}
        if not isinstance(slo, SLOSpec):
            slo = SLOSpec.from_json(dict(slo))
        classes.append(TrafficClass(name=name, slo=slo, **cfg))
    return classes


def assign_classes(n_tasks: int, classes: Sequence[TrafficClass],
                   seed: int = 0) -> List[str]:
    """Deterministic weighted class assignment for ``n_tasks``."""
    if not classes:
        return [""] * n_tasks
    rng = np.random.default_rng(seed)
    weights = np.asarray([max(c.weight, 0.0) for c in classes],
                         dtype=np.float64)
    if weights.sum() <= 0.0:
        weights = np.ones(len(classes))
    probs = weights / weights.sum()
    names = [c.name for c in classes]
    idx = rng.choice(len(names), size=n_tasks, p=probs)
    return [names[i] for i in idx]


def slo_targets(classes: Sequence[TrafficClass]) -> Dict[str, SLOSpec]:
    """The ``{name: SLOSpec}`` mapping ``SLOMonitor`` consumes."""
    return {c.name: c.slo for c in classes}


def bulk_class_names(classes: Sequence[TrafficClass]) -> List[str]:
    """Names of the ``bulk=True`` classes — the ``bulk_classes``
    argument of the reference's ``serving.router.Router``."""
    return [c.name for c in classes if c.bulk]


def request_deadline(arrival: float, cls: str,
                     targets: Dict[str, SLOSpec]) -> float:
    """Absolute deadline of one request: arrival + its class's e2e SLO
    target.  ``inf`` (class unknown or no e2e target) = never times
    out; the failure-aware serving path (``serving.faults``) sheds
    queued requests past this point before admission."""
    spec = targets.get(cls)
    if spec is None:
        return float("inf")
    return arrival + spec.target("e2e")
