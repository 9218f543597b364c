#!/usr/bin/env python3
"""A benchmark cell's window on the card: what tracing costs, and the
device's idle time by host phase.

    python3 scripts/window_phases.py --workload <cell> --seed <n>

from the root of a checkout, on a card.  Set-up and warm-up are the
benchmark's (``rtbench/harness.py``).  Then the cell's schedule (the
benchmark's ``run_seconds``) is served ``ROUNDS`` times untraced and as
often with an ``Observability`` bundle, in turns, each on a fresh engine,
and once more for its first ``harness.TRACE_SECONDS`` under the profiler
(the benchmark's replay).  It runs on a checkout from before the
wall-clock tracks too, and then leaves their numbers out, so that two
checkouts' costs can be set side by side on one seed.  Prints one JSON
object:

  * ``windows``: each window's wall seconds, whether it was traced, what
    the bundle's emitters timed themselves (``obs_overhead_s``) and the
    cyclic garbage collector's seconds inside it (``gc_s``);
  * ``cost``: each round's traced wall over its untraced wall, less 1,
    and their median;
  * ``phase_cover``: the host phases' summed seconds over the last
    traced window's wall seconds (the phases tile ``serve()``);
  * ``idle_by_phase``: ``obs.trace.idle_by_phase`` of the last traced
    window, on the unprofiled window itself;
  * ``replay``: the profiled replay's idle share and idle seconds by
    range, as the benchmark's breakdown reports them;
  * ``metrics``: the benchmark's readers of the wall spans, on the last
    traced window.
"""

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "rtbench"), str(ROOT / "src")]

ROUNDS = 4
READERS = ("device.idle_share.window", "engine.dispatch_device_share.rt",
           "sched.predict_share")


class _GCClock:
    """The cyclic collector's pauses, as (start, seconds)."""

    def __init__(self):
        self.pauses, self._t = [], None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((self._t, time.perf_counter() - self._t))
            self._t = None

    def within(self, t0: float, t1: float) -> float:
        return sum(d for t, d in self.pauses if t0 <= t <= t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch
    import harness
    from repro_torch.obs import Observability, trace
    if not torch.cuda.is_available():
        print("window_phases: needs a CUDA card", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(args.workload)
    su = harness.setup(cell, args.seed, torch.device("cuda"))
    harness.warm_up(su, cell.rate, args.seed)

    def schedule():
        return harness.requests_for(su, cell.rate, bench["run_seconds"],
                                    args.seed)

    clock = _GCClock()
    windows, obs = [], None
    for _ in range(ROUNDS):
        for traced in (False, True):
            obs = Observability() if traced else None
            wall, t0, result = harness._serve(su, schedule(), obs=obs)[:3]
            windows.append({"traced": traced, "wall_s": wall,
                            "obs_overhead_s": result["obs_overhead_s"],
                            "gc_s": clock.within(t0, t0 + wall)})
    gc.callbacks.remove(clock)
    walls = [w["wall_s"] for w in windows]
    cost = [on / off - 1.0 for off, on in zip(walls[0::2], walls[1::2])]
    head = [r for r in schedule() if r.arrival < harness.TRACE_SECONDS]
    replay = harness._serve(su, head, profile=True)[4]
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "windows": windows,
           "cost": {"rounds": cost, "median": statistics.median(cost)},
           "replay": {
               "idle_share": 1.0 - replay["busy_s"] / replay["window_s"],
               "idle_gaps": replay["idle_gaps"]}}
    spans = obs.trace.spans
    if any(s.track == "host" for s in spans):
        host = sum(s.dur for s in spans
                   if s.track == "host" and s.name != "engine.iteration")
        ctx = {"spans": [(s.name, s.dur) for s in spans],
               "wall_s": walls[-1], "cpu_slowdown": su.persona.cpu_slowdown}
        out["phase_cover"] = host / walls[-1]
        out["idle_by_phase"] = trace.idle_by_phase(obs.trace)
        out["metrics"] = {
            name: harness.load_module(
                harness.HERE / "metrics" / f"{name}.py",
                "rtbench_metric_" + name.replace(".", "_")).read(ctx)
            for name in READERS}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
