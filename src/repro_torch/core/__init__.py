"""RT-LM core: the paper's contribution (port of ``repro.core``).

  rulegen    — six linguistic-uncertainty rules (RULEGEN)       [copy]
  predictor  — lightweight MLP m_theta in PyTorch: rule scores -> output length
  priority   — Eq. 2 slack / Eq. 3 uncertainty-aware priorities [copy]
  scheduler  — Algorithm 1 UASCHED + FIFO/HPF/LUF/MUF baselines [copy]
  datagen    — six-type synthetic corpora + benchmark mixes     [copy]
  personas   — published per-LM coefficient profiles            [copy]
  workload   — arrival traces + traffic classes with SLO targets [copy]
  simulator  — discrete-event serving-node model: simulate,
               simulate_continuous, simulate_replicated, run_policy [copy]

The engine's parity tests keep the reference's simulator
(``repro.core.simulator``) as their oracle; ``tests/test_torch_simulator.py``
holds this copy to it.
"""

from . import (datagen, personas, predictor, priority, rulegen,  # noqa
               scheduler, simulator, workload)
