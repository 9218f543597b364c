"""Rate-limited warnings with countable fallback events (port of
``repro.obs.log``).

The port keeps the ledger and the engine's ``fallback_events`` key, but
none of its paths degrades silently: a kernel that fails to build
raises, and so does a CUDA graph capture that fails.  The reference's
account follows.

The serving stack degrades silently in two places: ``use_pallas=None``
auto-detection falls back to the jnp kernel paths off-TPU, and AOT
warmup failure degrades to jit-on-first-call.  Both used to be ad-hoc
one-shot ``logger.warning`` patterns — visible once in stderr, then
gone, and never countable.  This module centralizes the pattern:

  * each degradation site calls ``warn_once(logger, key, msg, ...)``;
  * the FIRST occurrence per key logs at WARNING; repeats within
    ``min_interval_s`` are suppressed (rate limit, not one-shot — a
    long-lived process resurfaces a persistent fallback periodically);
  * EVERY occurrence increments the key's counter, so
    ``fallback_count()`` deltas make silent fallbacks countable in
    serve results (``ServingEngine._result["fallback_events"]``)
    instead of only greppable in stderr;
  * ``reset(key)`` re-arms logging without clearing counts — what
    ``generate.reset_fallback_warning`` maps onto, keeping the
    per-serve re-arm semantics of the old pattern.

A module-level singleton (``FALLBACKS``) backs the serving stack; unit
tests may construct private ``RateLimitedLogger`` instances.

Multi-replica scoping: with R engine replicas in one process,
a purely process-global ledger makes per-replica accounting wrong in
both directions — replica 3's first jnp-fallback is rate-SUPPRESSED
because replica 0 logged the same key seconds earlier, and a
process-global count delta attributes every replica's events to
whichever engine computed the delta.  ``scope(ledger)`` pushes an
engine-owned ledger for the duration of its build/serve work:
``warn_once`` then counts the occurrence in BOTH the global ledger
(process-wide observability is still wanted) and every active scope,
while the emission decision comes from the innermost scope — so each
replica's first fallback logs, and ``ServingEngine`` reports
``fallback_events`` from its own ledger's counts.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional


class RateLimitedLogger:
    """Per-key rate-limited warning emitter with occurrence counters."""

    def __init__(self, min_interval_s: float = 300.0):
        self.min_interval_s = min_interval_s
        self._last_emit: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.suppressed: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def note(self, key: str) -> bool:
        """Count one occurrence and decide (without logging) whether
        this ledger would emit it — the rate-limit bookkeeping half of
        ``warn``, reusable when the emission decision belongs to a
        different ledger (see ``warn_once``)."""
        self.counts[key] = self.counts.get(key, 0) + 1
        now = time.monotonic()
        last = self._last_emit.get(key)
        if last is not None and now - last < self.min_interval_s:
            self.suppressed[key] = self.suppressed.get(key, 0) + 1
            return False
        self._last_emit[key] = now
        return True

    def warn(self, logger, key: str, msg: str, *args) -> bool:
        """Count the occurrence; emit at WARNING unless the key logged
        within ``min_interval_s``.  Returns True when emitted."""
        if not self.note(key):
            return False
        logger.warning(msg, *args)
        return True

    # ------------------------------------------------------------------
    def reset(self, key: Optional[str] = None) -> None:
        """Re-arm emission (counts are NOT cleared — they are the
        observable record).  ``None`` re-arms every key."""
        if key is None:
            self._last_emit.clear()
        else:
            self._last_emit.pop(key, None)

    def count(self, key: Optional[str] = None) -> int:
        if key is not None:
            return self.counts.get(key, 0)
        return sum(self.counts.values())


#: process-wide fallback ledger for the serving stack.  Keys in use:
#:   "jnp-fallback"  — use_pallas auto-detection fell back off-TPU
#:   "aot-warmup"    — AOT warmup failed; degraded to jit-on-first-call
FALLBACKS = RateLimitedLogger()

#: active scoped ledgers, innermost last (``scope``) — each engine
#: replica pushes its own around factory build + serve
_SCOPES: List[RateLimitedLogger] = []


@contextlib.contextmanager
def scope(ledger: RateLimitedLogger):
    """Route ``warn_once`` bookkeeping into ``ledger`` for the block:
    occurrences count in the global ledger AND every active scope, and
    the innermost scope owns the rate-limit emission decision (so a
    fresh replica's first fallback is not suppressed by an earlier
    replica having logged the same key)."""
    _SCOPES.append(ledger)
    try:
        yield ledger
    finally:
        _SCOPES.pop()


def warn_once(logger, key: str, msg: str, *args) -> bool:
    """Module-level convenience over the shared ``FALLBACKS`` ledger
    plus any active ``scope`` ledgers (innermost decides emission)."""
    emit = FALLBACKS.note(key)
    for ledger in _SCOPES:
        emit = ledger.note(key)
    if emit:
        logger.warning(msg, *args)
    return emit


def fallback_count() -> int:
    """Total degradation events so far (all keys) — process-wide; a
    replica-accurate count comes from its engine's own scoped ledger
    (``ServingEngine.fallback_ledger.count()``)."""
    return FALLBACKS.count()
