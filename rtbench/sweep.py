#!/usr/bin/env python3
"""Find a cell's knee on the card: one set-up, one serve a rate.

    python3 rtbench/sweep.py --workload <name> --rates 100,200,300 \
        --seconds 10 --seed <n> [--out build/sweep.jsonl]

For each rate (requests per engine-clock second) one ``serve()`` of the
cell's traffic at that rate over ``--seconds`` of the engine clock, and one
line: the window's wall seconds, the tokens per wall second, the time to
first token, and the mean queue wait of the requests arriving in each
quarter of the schedule with the drain after its last arrival.  The first
quarter carries the graph capture at the serve's start, so the rates are
told apart by the last two: the knee is the highest rate whose last two
quarters' waits stay within 1.5x of the next lower rate's.  Past it the
backlog grows, or the capture's backlog takes the whole window to drain,
and those waits stand several times higher.  The cell's configuration
file records the knee.
Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def quarters(records, span):
    out = []
    for q in range(4):
        lo, hi = span * q / 4, span * (q + 1) / 4
        w = [r["queue_wait_s"] for r in records
             if lo <= r["arrival"] < hi and r["queue_wait_s"] >= 0]
        out.append(sum(w) / len(w) if w else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    import harness
    cell = harness.load_cell(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    dev = torch.device("cuda")
    su = harness.setup(cell, args.seed, dev)
    harness.warm_up(su, rates[0], args.seed)
    for rate in rates:
        reqs = harness.requests_for(su, rate, args.seconds, args.seed)
        win = harness.run_window(su, lambda: reqs, trace=False)
        done = [r for r in win.requests if r["finish"] >= 0]
        span = reqs[-1].arrival
        ttft = [r["token_times"][0] - r["arrival"] for r in done]
        line = {"workload": args.workload, "rate": rate,
                "requests": len(reqs), "wall_s": win.wall_s,
                "schedule_s": span,
                "drain_s": max(r["finish"] for r in done) - span,
                "tokens_per_s": sum(len(r["out_tokens"]) for r in done)
                / win.wall_s,
                "ttft_p50_s": float(np.percentile(ttft, 50)),
                "ttft_p95_s": float(np.percentile(ttft, 95)),
                "queue_wait_by_quarter_s": quarters(done, span),
                "offloaded": sum(r["lane"] == "cpu" for r in done),
                "peak_concurrency": win.result["peak_concurrency"],
                "card": torch.cuda.get_device_name(0),
                "at": time.strftime("%Y-%m-%dT%H:%M:%S")}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
