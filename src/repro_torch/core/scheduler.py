"""UASCHED (Algorithm 1) and the four baseline policies.

Copy of ``repro.core.scheduler``; only ``offline_profile`` differs, in
taking the ``device`` m_theta trains on.

A *policy* is driven through two interfaces; the discrete-event
simulator (core/simulator.py) and the real serving engine
(serving/engine.py) support both:

  * ``select(queue, now)`` — batch-former: at a dispatch instant return
    (gpu_batch, cpu_batch, remaining_queue) and run the gpu batch to
    completion (the paper's execution model).
  * ``admit(queue, now, running)`` — incremental admission for
    continuous (iteration-level) batching: choose ONE task for a decode
    slot freed this step, given the tasks currently occupying the other
    slots.  Uncertainty-aware policies consolidate against the RUNNING
    batch (admit the candidate whose predicted length is homogeneous
    with it) and keep Alg. 1's tau offload as a congestion relief valve.

  FIFO  — arrival order, fixed batch size, uncertainty-oblivious.
  HPF   — earliest priority point first (deadline-monotonic analogue).
  LUF   — least uncertainty first.
  MUF   — most uncertainty first.
  RT-LM — Alg. 1: UP priority order (Eq. 3), accumulate b*C, re-sort by
          ascending u, lambda-segmentation, u > tau offloaded to CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import datagen, predictor as predictor_lib, priority as prio
from .personas import Persona

Batch = List[prio.SimTask]


@dataclasses.dataclass
class PolicyConfig:
    alpha: float = 1.0       # Eq. 3 uncertainty weight (paper Fig. 13a)
    lam: float = 1.5         # lambda — max u ratio within a batch
    b: float = 1.8           # batch-accumulation multiplier
    k: float = 0.9           # offload quantile
    u_scale: float = 30.0    # Eq. 3 normalization (set from train set)
    tau: float = 1e18        # malicious threshold (set from train set)


class Policy:
    """Base: uncertainty-oblivious FIFO."""

    name = "fifo"
    uses_uncertainty = False

    def __init__(self, persona: Persona, pcfg: Optional[PolicyConfig] = None):
        self.persona = persona
        self.pcfg = pcfg or PolicyConfig()

    # ------------------------------------------------------------------
    def assign_priority(self, t: prio.SimTask) -> float:
        return -t.r  # FIFO: earlier arrival = higher priority

    def select(self, queue: Batch, now: float
               ) -> Tuple[Batch, Batch, Batch]:
        order = sorted(queue, key=self.assign_priority, reverse=True)
        C = self.persona.batch_size
        return order[:C], [], order[C:]

    # ------------------------------------------------------------------
    def max_batch(self) -> int:
        """Largest GPU batch ``select`` can return — the row count the
        engine preallocates its batch-mode executables with.
        Consolidating policies extend past C_f up to b * C_f (Alg. 1)."""
        return self.persona.batch_size

    # ------------------------------------------------------------------
    def admit(self, queue: Batch, now: float,
              running: Sequence[prio.SimTask] = ()
              ) -> Tuple[Optional[prio.SimTask], str, Batch]:
        """Incremental admission (continuous batching): pick ONE task for
        a freed decode slot.  Returns (task | None, lane, rest) where
        lane is "gpu" (admit into the slot) or "cpu" (offload)."""
        if not queue:
            return None, "gpu", []
        order = sorted(queue, key=self.assign_priority, reverse=True)
        return order[0], "gpu", order[1:]


class HPF(Policy):
    """Highest Priority-point First [48] — earliest d_J first."""

    name = "hpf"

    def assign_priority(self, t: prio.SimTask) -> float:
        return -t.d


class LUF(Policy):
    name = "luf"
    uses_uncertainty = True

    def assign_priority(self, t: prio.SimTask) -> float:
        return -t.u


class MUF(Policy):
    name = "muf"
    uses_uncertainty = True

    def assign_priority(self, t: prio.SimTask) -> float:
        return t.u


class SlackEq2(Policy):
    """Pure slack-based priority (paper Eq. 2) — the 'straightforward'
    variant the paper contrasts UP against."""

    name = "slack-eq2"
    uses_uncertainty = True

    def assign_priority(self, t: prio.SimTask) -> float:
        return prio.eq2_priority(t.d, t.r, t.u, self.persona.eta)


class UP(Policy):
    """Uncertainty-aware Prioritization only (ablation arm: no
    consolidation, no offloading) — Eq. 3 order, fixed batch size."""

    name = "up"
    uses_uncertainty = True

    def assign_priority(self, t: prio.SimTask) -> float:
        return prio.eq3_priority(t.d, t.r, t.u, self.persona.eta,
                                 self.pcfg.alpha, self.pcfg.u_scale)


class UPC(UP):
    """UP + dynamic consolidation (ablation arm: no offloading)."""

    name = "up+c"
    offload = False

    def select(self, queue: Batch, now: float
               ) -> Tuple[Batch, Batch, Batch]:
        pcfg, C = self.pcfg, self.persona.batch_size
        for t in queue:
            t.p = self.assign_priority(t)
        order = sorted(queue, key=lambda t: t.p, reverse=True)

        cpu_batch: Batch = []
        tmp: Batch = []
        rest: Batch = []
        target = int(math.floor(pcfg.b * C))
        # §III-C frames offloading as a relief valve "under overloaded
        # situations or ... computation-demanding workloads": engage the
        # CPU lane only when the GPU has a backlog (queue beyond one
        # batch) — otherwise the slow lane only inflates tail latency.
        congested = len(order) > target
        for t in order:
            if self.offload and congested and \
                    self._consolidation_u(t) > pcfg.tau:
                cpu_batch.append(t)           # Alg. 1 line 15-16
            elif len(tmp) < target:
                tmp.append(t)                 # line 18
            else:
                rest.append(t)
        # lines 19-25: re-sort by ascending uncertainty, lambda-segment.
        # NB Alg. 1 line 22 is a disjunction: `while u <= lam*u_prev OR
        # count < C_f` — the batch always reaches C when enough tasks are
        # queued, and dynamic consolidation may *extend* it (up to b*C)
        # while uncertainty stays homogeneous; the lambda cut never
        # starves the executor below C.
        tmp.sort(key=self._consolidation_u)
        count = 0
        u_prev = self._consolidation_u(tmp[0]) if tmp else 0.0
        while count < len(tmp) and (
                count < C
                or self._consolidation_u(tmp[count])
                <= pcfg.lam * max(u_prev, 1e-9)):
            u_prev = self._consolidation_u(tmp[count])
            count += 1
        gpu_batch = tmp[:count]
        rest = tmp[count:] + rest
        # keep the executor busy: if nothing made the GPU cut, ship the
        # CPU batch; if both empty, fall back to the front of the queue.
        if not gpu_batch and not cpu_batch and rest:
            gpu_batch, rest = rest[:C], rest[C:]
        return gpu_batch, cpu_batch, rest

    def max_batch(self) -> int:
        C = self.persona.batch_size
        return max(C, int(math.floor(self.pcfg.b * C)))

    # ------------------------------------------------------------------
    def _consolidation_u(self, t: prio.SimTask) -> float:
        """The uncertainty key consolidation/offload decisions use (the
        tail-aware variant overrides this with the P90 prediction)."""
        return t.u

    def admit(self, queue: Batch, now: float,
              running: Sequence[prio.SimTask] = ()
              ) -> Tuple[Optional[prio.SimTask], str, Batch]:
        """Continuous-batching Alg. 1 analogue.  Priority (Eq. 3) ranks
        the queue; the slot goes to whichever of the top-⌈b⌉ candidates
        is most length-homogeneous with the RUNNING batch (dynamic
        consolidation against live slots instead of a formed batch).
        Under congestion, a predicted-malicious (u > tau) front-runner is
        offloaded to the CPU lane exactly as in batch mode."""
        if not queue:
            return None, "gpu", []
        pcfg, C = self.pcfg, self.persona.batch_size
        for t in queue:
            t.p = self.assign_priority(t)
        order = sorted(queue, key=lambda t: t.p, reverse=True)
        congested = len(order) > int(math.floor(pcfg.b * C))
        if self.offload and congested and \
                self._consolidation_u(order[0]) > pcfg.tau:
            return order[0], "cpu", order[1:]
        window = order[:max(1, int(math.ceil(pcfg.b)))]
        if running:
            anchor = (sum(self._consolidation_u(t) for t in running)
                      / len(running))
            pick = min(window,
                       key=lambda t: abs(self._consolidation_u(t) - anchor))
        else:
            # empty engine: seed the batch with the least-uncertain of
            # the candidates (Alg. 1's ascending-u re-sort analogue)
            pick = min(window, key=self._consolidation_u)
        return pick, "gpu", [t for t in order if t is not pick]


class RTLM(UPC):
    """The full UASCHED: UP + consolidation + strategic CPU offloading."""

    name = "rt-lm"
    offload = True


class RTLMQ(RTLM):
    """Beyond-paper: RT-LM with tail-aware consolidation — batched decode
    runs until its LONGEST member, so batches are consolidated and
    offloaded on the predicted P90 output length (pinball-loss predictor)
    while priorities keep using the mean prediction."""

    name = "rt-lm-q"

    def _consolidation_u(self, t):
        # consolidation/offload on tail u; priorities (assign_priority)
        # keep using the mean prediction t.u
        return t.u_hi


POLICIES = {p.name: p for p in (Policy, HPF, LUF, MUF, SlackEq2,
                               UP, UPC, RTLM, RTLMQ)}


# ---------------------------------------------------------------------------
# offline profiling (Alg. 1 lines 2-9)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OfflineProfile:
    predictor: predictor_lib.Predictor
    tau: float
    u_scale: float
    persona_name: str
    # beyond-paper: optional tail predictor (pinball-trained, e.g. P90)
    predictor_hi: Optional[predictor_lib.Predictor] = None

    def policy_config(self, alpha=1.0, lam=1.5, b=1.8) -> PolicyConfig:
        return PolicyConfig(alpha=alpha, lam=lam, b=b,
                            u_scale=self.u_scale, tau=self.tau)


def offline_profile(train_tasks: Sequence[datagen.Task], persona: Persona,
                    *, k: float = 0.9, epochs: int = 100,
                    seed: int = 0,
                    tail_quantile: Optional[float] = None,
                    device=None) -> OfflineProfile:
    """Train m_theta on D_train, derive tau = quantile_k of train scores.

    C_f comes from the persona (the paper reads it off GPU-utilization
    profiling, Fig. 8a — those published values are baked into the
    persona table).  tail_quantile additionally trains a pinball-loss
    tail predictor (beyond-paper, see RTLMQ).  m_theta trains on
    ``device`` (the card unless ``device="cpu"``).
    """
    pred = predictor_lib.train_predictor(
        train_tasks, persona.name, epochs=epochs, seed=seed, device=device)
    scores = pred.score_batch([t.text for t in train_tasks])
    tau = float(np.quantile(scores, k))
    u_scale = float(np.quantile(scores, 0.95))
    pred_hi = None
    if tail_quantile is not None:
        pred_hi = predictor_lib.train_predictor(
            train_tasks, persona.name, epochs=epochs, seed=seed + 1,
            quantile=tail_quantile, device=device)
    return OfflineProfile(predictor=pred, tau=tau, u_scale=u_scale,
                          persona_name=persona.name, predictor_hi=pred_hi)


def make_sim_tasks(tasks: Sequence[datagen.Task], profile: OfflineProfile,
                   persona: Persona, arrivals: Sequence[float],
                   xi: float = 2.0) -> List[prio.SimTask]:
    """Attach predictions + priority points to a trace of tasks."""
    scores = profile.predictor.score_batch([t.text for t in tasks])
    if profile.predictor_hi is not None:
        scores_hi = profile.predictor_hi.score_batch(
            [t.text for t in tasks])
    else:
        scores_hi = scores
    out = []
    for t, u, uh, r in zip(tasks, scores, scores_hi, arrivals):
        ilen = float(len(t.text.split()))
        d = prio.priority_point(r, ilen, persona.phi, t.deadline, xi=xi)
        out.append(prio.SimTask(
            task=t, u=float(max(u, 0.0)), u_hi=float(max(uh, u, 0.0)),
            r=float(r), d=d, input_len=ilen,
            true_out_len=t.out_lens[persona.name]))
    return out
