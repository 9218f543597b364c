"""Batched generation and the engine's executables (port of
``repro.serving.generate``).

``generate`` is host-loop greedy decoding of a batch over the contiguous
ring cache, with early exit when every row is done: the engine's batch
mode and bulk lane, and the vlm and encdec families' serving path at
model level (``patches=`` / ``frames=``).  ``prefill_chunked`` drives one prompt through the
single-chunk paged prefill (``model.prefill_chunk``), chunk by chunk: what
the reference's ``make_chunk_prefill_fn`` executable is called for.  Both
run eagerly.

``GraphExecutable`` is the counterpart of the reference's
``JitExecutable``: the continuous engine dispatches every device step of
its loops through one (the decode window, the stall admission, the
copy-on-write page copy, the fused ragged prefill), and on the card each
shape key replays a captured CUDA graph instead of launching the eager
model's thousands of kernels one by one.  ``disable_graphs()`` is the
counterpart of ``jax.disable_jit()``.  The reference's cross-engine
factory memo (``_memoized``) has no counterpart: a graph reads the
storage of the cache it was captured against, and each engine owns its
cache, so each engine owns its executables.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models import model as model_lib

PAD_ID = 0


@torch.no_grad()
def generate(params, cfg, tokens: torch.Tensor, *, max_new_tokens: int,
             eos_id: int = 1, max_lens=None, patches=None, frames=None):
    """Greedy-decode the (B, S) batch ``tokens`` (a vlm config's
    ``patches`` or an encdec config's ``frames`` go to ``model.prefill``;
    the cache then also holds the patch positions).  Returns (tokens
    (B, T <= max_new_tokens) i32, lengths (B,) i32), both on the device.

    ``max_lens``: optional (B,) per-row output caps; a row stops
    contributing at its cap, but the batch steps until its LONGEST row
    finishes (the run-to-completion head-of-line effect)."""
    max_len = tokens.shape[1] + max_new_tokens + 8
    if cfg.frontend == "vision":
        max_len += cfg.num_patch_tokens
    cache, last_logits = model_lib.prefill(params, cfg, tokens, max_len,
                                           patches=patches, frames=frames)
    B = tokens.shape[0]
    dev = tokens.device
    token = torch.argmax(last_logits, -1).to(torch.int32)[:, None]
    done = token[:, 0] == eos_id
    lengths = torch.ones((B,), dtype=torch.int32, device=dev)
    if max_lens is not None:
        max_lens = torch.as_tensor(max_lens, dtype=torch.int32, device=dev)
        done = done | (lengths >= max_lens)
    out = [token]
    for _ in range(max_new_tokens - 1):
        if bool(done.all()):
            break
        token, _ = model_lib.decode_step(params, cfg, cache, token)
        token = torch.where(done[:, None], PAD_ID, token)
        lengths = lengths + (~done).to(torch.int32)
        done = done | (token[:, 0] == eos_id)
        if max_lens is not None:
            done = done | (lengths >= max_lens)
        out.append(token)
    return torch.cat(out, dim=1), lengths


@torch.no_grad()
def prefill_chunked(params, cfg, cache: dict, tokens: torch.Tensor,
                    slot: int, table_row: torch.Tensor, *, chunk_size: int,
                    use_kernels: bool) -> torch.Tensor:
    """Prefill the (1, S) prompt ``tokens`` into the paged cache through
    ``model.prefill_chunk``, ``chunk_size`` tokens at a time, from
    position 0.  table_row (nb,) i32 must back every position.
    Updates ``cache`` in place (pages, ``pos[slot]``); returns the final
    chunk's last_logits (V,) f32, which feed the first sampled token."""
    S = tokens.shape[1]
    if S == 0:
        raise ValueError("empty prompt")
    for lo in range(0, S, chunk_size):
        logits = model_lib.prefill_chunk(
            params, cfg, cache, tokens[:, lo:lo + chunk_size], slot,
            table_row, lo, use_kernels=use_kernels)
    return logits


# ---------------------------------------------------------------------------
# CUDA-graph executables
# ---------------------------------------------------------------------------

_eager = threading.local()


@contextlib.contextmanager
def disable_graphs():
    """Run every ``GraphExecutable`` dispatch of this thread eagerly while
    the context is open (``jax.disable_jit()``'s counterpart): nothing is
    captured or replayed.  Nests."""
    _eager.depth = getattr(_eager, "depth", 0) + 1
    try:
        yield
    finally:
        _eager.depth -= 1


def graphs_disabled() -> bool:
    return getattr(_eager, "depth", 0) > 0


def _open_libraries(stream, device: torch.device) -> None:
    """Run one small product of each kind the model makes (cuBLAS and
    cuBLASLt, bf16 and float32) on the capture stream: cuBLAS creates
    its handle at a thread's first product, and its workspace at a
    stream's, neither of which a capture allows."""
    if device.type != "cuda":
        return
    with torch.cuda.stream(stream):
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.zeros((16, 16), dtype=dtype, device=device)
            torch.addmm(a, a, a)
            torch.bmm(a[None], a[None])
            a @ a
    stream.synchronize()


def _is_input(a) -> bool:
    """Arguments that vary between calls and live in a static buffer of
    the graph: arrays and tensors.  Every other argument (parameters,
    config, the cache dict) is bound by identity at capture."""
    return isinstance(a, (np.ndarray, torch.Tensor))


class _Captured:
    """One key's graph: its static inputs (None for a bound argument),
    the bound arguments and static kwargs it was captured with, its
    static outputs and its first node's timing event (None untimed)."""

    def __init__(self, graph, statics, args, kwargs, out, start=None):
        self.graph = graph
        self.statics = statics
        self.bound = [None if s is not None else a
                      for s, a in zip(statics, args)]
        self.kwargs = kwargs
        self.out = out
        self.start = start

    def check(self, args, kwargs) -> None:
        if len(args) != len(self.statics) or kwargs != self.kwargs:
            raise ValueError("a graph replays only the call it captured: "
                             "other arguments or static kwargs")
        for s, b, a in zip(self.statics, self.bound, args):
            if s is None and a is not b:
                raise ValueError(
                    "a graph replays only against the objects it captured "
                    "(parameters, cache); another object needs another "
                    "executable")
            if s is not None and tuple(a.shape) != tuple(s.shape):
                raise ValueError(f"input of shape {tuple(a.shape)}, the "
                                 f"graph's is {tuple(s.shape)}")


class GraphExecutable:
    """An engine entry point plus its CUDA graphs, one per shape key.

    ``__call__`` runs ``fn`` eagerly.  ``warm(key, args, static_kwargs)``
    captures one ``torch.cuda.CUDAGraph`` of ``fn(*args, **static_kwargs)``
    under ``key`` (idempotent per key): arrays and tensors among ``args``
    are copied into static device buffers that the graph reads, and every
    other argument (parameters, config, cache) is bound by identity, so
    the graph belongs to the storage of that cache.  ``call_aot(key,
    *args, **static_kwargs)`` copies the inputs into the key's static
    buffers, replays and returns the static outputs; at an unwarmed key it
    runs ``fn`` eagerly and then captures the key, so later calls replay
    (the reference's trace on first call).  A replay overwrites the
    static outputs, and the executables of one engine share one memory
    pool: a caller consumes a result before its next dispatch of any of
    them.

    Nothing is ever captured on the CPU, nor under ``disable_graphs()``:
    ``warm`` records nothing and ``call_aot`` runs eagerly.  The CPU engine
    is the tests' engine, and callers ask for it with ``device="cpu"``.  A
    capture that fails raises; there is no fallback.

    Capture runs without an eager warm-up call: the graph only records,
    so the cache is not touched, and an eager run on the live cache would
    change it.  The graph's own ``torch.empty`` buffers (the kernels'
    workspaces and outputs) come from the pool.  The kernels' wrappers
    count their launches on the host, where a capture calls them and a
    replay does not: a graphed serve's counts are its eager calls and its
    captures, and what a replay ran shows in the profiler, which names
    the kernels inside a graph.

    Unlike the reference's ``JitExecutable``, whose dispatches run inside
    a ``TraceAnnotation("dispatch:<name>")``, an executable opens no
    profiler range: the engine's ``dispatch.*`` phases (``obs.Phases``)
    name each dispatch, on the wall clock, and as profiler ranges when a
    profiler runs.  ``starts`` (None, or a list the engine hands over for
    a traced serve on the card) marks where each call starts on the card:
    a capture then records a timing event as its graph's first node, and
    every call appends the event that marks its start, the graph's own on
    a replay (reached when the stream reaches the graph, so the static
    input copies and the host's launch come before it) or one recorded
    just before an eager call.  A replayed graph re-records its event, so
    a caller reads it before the key's next replay.  ``replays`` counts
    replays and ``capture_s`` the seconds spent capturing, until
    ``reset``.
    """

    def __init__(self, fn, name: str, device):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.pool = None
        self.aot: Dict[tuple, _Captured] = {}
        self.starts: Optional[list] = None
        self.replays = 0
        self.capture_s = 0.0

    def reset(self, pool=None) -> None:
        """Drop every graph (their cache is gone) and the counters; later
        captures share ``pool``."""
        self.aot.clear()
        self.pool = pool
        self.replays = 0
        self.capture_s = 0.0

    def captures(self) -> bool:
        """Whether this executable captures and replays right now."""
        return self.device.type == "cuda" and not graphs_disabled()

    def _eager_args(self, args):
        """Host arrays to fresh device tensors; the rest as it is."""
        return [torch.tensor(a, device=self.device)
                if isinstance(a, np.ndarray) else a for a in args]

    def __call__(self, *args, **kwargs):
        return self.fn(*self._eager_args(args), **kwargs)

    def warm(self, key, args, static_kwargs: Optional[dict] = None) -> None:
        """Capture ``key`` from example ``args`` (their values are not
        read: the capture only records); idempotent per key."""
        if key not in self.aot and self.captures():
            self._capture(key, args, dict(static_kwargs or {}))

    def call_aot(self, key, *args, **static_kwargs):
        cap = self.aot.get(key) if self.captures() else None
        if cap is None:
            if self.starts is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.starts.append(ev)
            out = self.fn(*self._eager_args(args), **static_kwargs)
            if self.captures():
                self._capture(key, args, static_kwargs)
            return out
        cap.check(args, static_kwargs)
        for s, a in zip(cap.statics, args):
            if s is not None:
                s.copy_(torch.from_numpy(np.ascontiguousarray(a))
                        if isinstance(a, np.ndarray) else a)
        cap.graph.replay()
        if self.starts is not None:
            self.starts.append(cap.start)
        self.replays += 1
        return cap.out

    def _capture(self, key, args, kwargs) -> None:
        statics = [None if not _is_input(a)
                   else torch.tensor(a, device=self.device)
                   if isinstance(a, np.ndarray)
                   else a.to(self.device, copy=True) for a in args]
        call = [s if s is not None else a for s, a in zip(statics, args)]
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self.pool)
        t0 = time.perf_counter()
        _open_libraries(capture.capture_stream, self.device)
        start = None
        with capture:
            if self.starts is not None:
                # an event node: each replay records it on the card
                start = torch.cuda.Event(enable_timing=True, external=True)
                start.record()
            out = self.fn(*call, **kwargs)
        self.capture_s += time.perf_counter() - t0
        self.aot[key] = _Captured(graph, statics, args, kwargs, out, start)
