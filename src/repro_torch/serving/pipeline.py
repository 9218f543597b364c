"""Async host pipeline: the completion worker (port of ``repro.serving.pipeline``).

``CompletionWorker`` takes the blocking readback of a launch off the serve
loop.  ``submit`` runs on the serve thread: for a CUDA tensor it issues a
``non_blocking`` copy into pinned host memory and records a
``torch.cuda.Event`` after it; the worker thread only waits on that event
and hands back the numpy view.  A CPU tensor is already computed when it is
submitted, so there is nothing to wait on.

Determinism contract (as in the reference): the worker does no scheduling.
Results come back strictly FIFO, ``dt`` is the launch-to-ready wall-clock
delta the serve loop charges to its virtual clock, and the loops consume a
window's result before any eviction or admission decision that depends on
it.  A failure on the worker thread re-raises at ``collect``.

Given a ``MetricsRegistry``, ``collect`` records how long the serve
thread blocked on the worker into the ``pipeline.collect_wait_s``
histogram, on the serve thread only: waits near zero mean the host's
work overlapped the device's, waits that track the launch's ``dt`` mean
the loop is device-bound.

Clocks: ``t0`` and ``dt`` are the host's wall clock; the engine charges
``dt`` to its virtual clock.  With ``timing=True`` (a traced serve on the
card) the completion event is a timing event, and ``submit`` returns it:
the engine reads the card's side of the dispatch from it (the end of a
``device.*`` span, ``obs.Phases``), with no sync beyond the one the
worker makes anyway.  Its time is when the stream passed the readback
copy, not when the worker woke: the difference is the handoff that
``dt`` includes and the device span does not.  The span starts at the
dispatch graph's first node (``generate.GraphExecutable.starts``), so the
host's launch is outside it, but it cannot see inside the replay: a gap
there counts as busy.  No profiler range of the executables' own
(``dispatch:<name>``) is left; the engine's ``dispatch.*`` phases name
each dispatch.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch


class CompletionWorker:
    """Daemon thread draining device completions off the serve loop."""

    def __init__(self, name: str = "completion-worker", metrics=None,
                 timing: bool = False):
        self._timing = timing
        self._in: "queue.Queue" = queue.Queue()
        self._out: "queue.Queue" = queue.Queue()
        self._closed = False
        self._wait_hist = (metrics.histogram("pipeline.collect_wait_s")
                           if metrics is not None else None)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # -- worker side ---------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._in.get()
            if item is None:                   # close() sentinel
                return
            host, event, t0 = item
            try:
                if event is not None:
                    event.synchronize()
                self._out.put((host.numpy(), time.perf_counter() - t0, None))
            except Exception as exc:           # re-raised at collect()
                self._out.put((None, time.perf_counter() - t0, exc))

    # -- scheduler side ------------------------------------------------
    def submit(self, tensor: torch.Tensor,
               t0: float) -> Optional[torch.cuda.Event]:
        """Start the readback of an in-flight result launched at ``t0``;
        returns the completion event (None for a CPU tensor)."""
        tensor = tensor.detach()
        event = None
        if tensor.device.type == "cuda":
            host = torch.empty(tensor.shape, dtype=tensor.dtype,
                               pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            event = torch.cuda.Event(enable_timing=self._timing)
            event.record()
        else:
            host = tensor.clone()
        self._in.put((host, event, t0))
        return event

    def collect(self) -> Tuple[np.ndarray, float]:
        """Block for the OLDEST submitted result; returns (host, dt).
        Raises whatever the readback raised on the worker thread."""
        if self._wait_hist is not None:
            t0 = time.perf_counter()
            host, dt, exc = self._out.get()
            self._wait_hist.record(time.perf_counter() - t0)
        else:
            host, dt, exc = self._out.get()
        if exc is not None:
            raise exc
        return host, dt

    def wait_snapshot(self) -> dict:
        """Snapshot of the collect-wait histogram so far ({} without a
        registry): the ``wall`` field of the engine's health snapshots,
        outside the parity view."""
        return (self._wait_hist.snapshot()
                if self._wait_hist is not None else {})

    def close(self, timeout: Optional[float] = 5.0) -> None:
        """Stop the worker and join its thread (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._in.put(None)
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "CompletionWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
