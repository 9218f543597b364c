"""Ambient sharding-policy context (a copy of ``repro.sharding.context``).

Model code is written once, device-layout-free; while a
:class:`repro_torch.sharding.policy.ShardingPolicy` is active
(``use_policy``), ``constrain(x, axes)`` redistributes ``x`` to the
policy's resolution of *logical* axis names to mesh axes; with no policy
active (single-device runs) it is the identity.  The state is
thread-local and the contexts nest.  A policy with a ``scope()`` context
(the port's ``ShardingPolicy``: DTensor's implicit replication of plain
tensors) is entered with it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

_state = threading.local()


def current():
    return getattr(_state, "policy", None)


@contextlib.contextmanager
def use_policy(policy):
    prev = getattr(_state, "policy", None)
    _state.policy = policy
    scope = getattr(policy, "scope", None)
    try:
        with (scope() if scope is not None else contextlib.nullcontext()):
            yield policy
    finally:
        _state.policy = prev


def under_current(fn):
    """``fn`` made to run under the policy active now, wherever it is
    called from: autograd recomputes a rematerialised layer on its own
    thread, where the thread-local policy is not set.  ``fn`` itself when
    no policy is active."""
    policy = current()
    if policy is None:
        return fn

    def run(*args, **kwargs):
        with use_policy(policy):
            return fn(*args, **kwargs)
    return run


def constrain(x, axes: Sequence[Optional[str]]):
    """Constrain tensor ``x`` with per-dim *logical* axis names (or None)."""
    policy = current()
    if policy is None:
        return x
    return policy.constrain(x, axes)
