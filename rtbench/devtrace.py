"""The traced run's device record: kernel time by name, busy time, idle gaps.

The walk over the profiler's raw device events is frozen from
``chip_smoke.profile_window`` at commit
bdcad9e275c09ab563fad5e5900be9a462e243e1 (``key_averages`` builds a
Python object per event and takes minutes over a serve; the raw walk
does not), with the tail it keeps open after the last kernel.  Added
here: the union of the device's busy intervals (kernels, copies and
fills on any stream), the idle gaps between them, and the host activity
each gap falls in.  The host activity is the benchmark's own: while the
window is traced, ``instrument`` wraps, on the engine object only, the
calls from the serve loop into each layer in ``record_function`` ranges,
so that they sit on the profiler's clock beside the device's events.
No trace is exported: the record stays in memory.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
from typing import Dict, List, Optional, Tuple

#: seconds the traced window stays open after the last kernel
PROFILE_TAIL_S = 0.25
WINDOW = "rtbench.window"

# the engine's calls into its layers, by the attribute that holds them:
# (object path from the engine, method, range name)
HOST_CALLS = (
    ("", "_to_sim_task", "host.predict"),
    ("policy", "admit", "host.admit"),
    ("", "_extend_block_tables", "host.block_tables"),
    ("", "_advance_decode_window", "host.window_bookkeeping"),
    ("", "_snapshot", "host.snapshot"),
    ("_ragged", "call_aot", "dispatch.prefill"),
    ("_window", "call_aot", "dispatch.decode_window"),
    ("", "_run_batch", "dispatch.bulk_batch"),
)


def instrument(engine, torch) -> None:
    """Wrap the engine's calls of ``HOST_CALLS`` in profiler ranges, on
    this engine object only (instance attributes shadow the methods)."""
    for path, name, label in HOST_CALLS:
        obj = engine
        for part in filter(None, path.split(".")):
            obj = getattr(obj, part)
        fn = getattr(obj, name)

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)
        functools.update_wrapper(wrapped, fn)
        setattr(obj, name, wrapped)


@contextlib.contextmanager
def traced(torch, enabled: bool):
    """A profiler over the block when ``enabled`` (CPU ranges and device
    activity), else nothing; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_TAIL_S)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(prof, torch, tags, top: int = 10) -> Optional[Dict]:
    """The window's device record from the profiler ``prof``: kernel
    seconds by tag (substring of the kernel's name), the union of busy
    intervals inside the window, the top device operations and the idle
    seconds by host activity.  None when the profiler saw no device
    activity."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    # a record_function range shows twice: on the host, and mirrored on
    # the device's timeline as an annotation that runs nothing
    ranges_ = {e.name() for e in events if e.device_type() != cuda}
    dev: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = {}
    by_tag = dict.fromkeys(tags, 0.0)
    ranges: List[Tuple[int, int, str]] = []
    window = None
    for e in events:
        name = e.name()
        t0, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if name in ranges_:
                continue
            dev.append((t0, t0 + dur))
            s = dur * 1e-9
            key = name[:96]
            by_name[key] = by_name.get(key, 0.0) + s
            for tag in tags:
                if tag in name:
                    by_tag[tag] += s
        elif name == WINDOW:
            window = (t0, t0 + dur)
        elif name.startswith(("host.", "dispatch.")):
            ranges.append((t0, t0 + dur, name))
    if not dev or window is None:
        return None
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b in dev
                   if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    # idle gaps inside the window, each charged to the innermost host
    # range around its midpoint
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    ranges.sort()
    starts = [r[0] for r in ranges]
    idle: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = "host.other"
        i = bisect.bisect_right(starts, mid)
        best = None
        for r0, r1, nm in reversed(ranges[max(0, i - 64):i]):
            if r0 <= mid < r1 and (best is None or r1 - r0 < best[0]):
                best = (r1 - r0, nm)
        if best is not None:
            label = best[1]
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "kernel_s": by_tag,
        "device_ops": sorted(([k, v] for k, v in by_name.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda r: -r[1])[:top],
        "device_events": len(dev),
    }
