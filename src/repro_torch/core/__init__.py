"""RT-LM core: the paper's contribution (port of ``repro.core``).

  rulegen    — six linguistic-uncertainty rules (RULEGEN)       [copy]
  predictor  — lightweight MLP m_theta in PyTorch: rule scores -> output length
  priority   — Eq. 2 slack / Eq. 3 uncertainty-aware priorities [copy]
  scheduler  — Algorithm 1 UASCHED + FIFO/HPF/LUF/MUF baselines [copy]
  datagen    — six-type synthetic corpora + benchmark mixes     [copy]
  personas   — published per-LM coefficient profiles            [copy]

The simulator and workload generator are not ported yet; the reference
simulator (``repro.core.simulator``) is the oracle the port's engine is
tested against.
"""

from . import (datagen, personas, predictor, priority, rulegen,  # noqa
               scheduler)
