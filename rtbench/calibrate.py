#!/usr/bin/env python3
"""Readings that set a cell's limit: the program's and the control's.

    python3 rtbench/calibrate.py --workload <name> --seeds 11,12,... \
        --seconds 5 [--faults fewer_experts,top6] [--out build/cal.jsonl]

One process; for each seed: the seed's weights, one ``serve()`` of the
cell's traffic at its own rate over ``--seconds`` of the engine clock, then
the check's sample judged twice by the plain reference: as served (the
program's reading), and with the tokens that the reference computed one
precision step below the configuration's, float8 e4m3 in place of bf16
(the control's reading), puts first at each position.  The limit lies
above the largest program reading and below the smallest control reading
(PERF.md gives both).  With ``--faults``, each seed's schedule is
served again with a fault planted in the program's MoE router, on the
same weights, and judged as served: ``fewer_experts`` gives the two
lowest-weighted of each token's top 8 choices weight 0 (as if the
program always dropped them); ``top6`` routes to the top 6 and
renormalises their weights; ``drop_top`` gives the highest-weighted
choice weight 0.  Not part of a benchmark run.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    import harness
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    su = None
    for seed in seeds:
        su = None                 # the last seed's weights go first
        gc.collect()
        torch.cuda.empty_cache()
        su = harness.setup(cell, seed, dev)
        reqs = harness.requests_for(su, cell.rate, args.seconds, seed)
        win = harness.run_window(su, lambda: reqs, trace=False)
        t0 = time.perf_counter()
        prog, pinfo = harness.run_checks(su, win, seed)
        t1 = time.perf_counter()
        ctrl, cinfo = harness.run_checks(su, win, seed, quant="fp8")
        t2 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                "requests": len(reqs),
                "offloaded": sum(r["lane"] == "cpu" for r in win.requests),
                "program": prog["max_logit_gap"]["value"],
                "control": ctrl["max_logit_gap"]["value"],
                "program_readings": pinfo, "control_readings": cinfo,
                "exact": {k: prog[k]["value"] for k in
                          ("unfinished", "wrong_length", "bad_token_ids")},
                "reference_s": t1 - t0, "control_s": t2 - t1,
                "card": torch.cuda.get_device_name(0)}
        lines = [line]
        for fault in filter(None, args.faults.split(",")):
            lines.append(dict(_faulted(su, args.seconds, seed, fault),
                              workload=args.workload, seed=seed))
        for ln in lines:
            print(json.dumps(ln), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(ln) + "\n")
    return 0


def _route_fault(real, fault: str):
    def route(params, xt, cfg):
        logits, probs, top_p, top_e = real(params, xt, cfg)
        k = cfg.experts_per_token
        top_p = top_p.clone()
        if fault == "drop_top":
            top_p[:, 0] = 0.0
        else:
            top_p[:, k - 2:] = 0.0
        if fault == "top6":
            top_p = top_p / top_p.sum(-1, keepdim=True)
        return logits, probs, top_p, top_e
    return route


def _faulted(su, seconds: float, seed: int, fault: str) -> dict:
    """The seed's schedule served again with ``fault`` in the router,
    judged."""
    import harness
    from repro_torch.models import moe
    real = moe.route
    moe.route = _route_fault(real, fault)
    try:
        win = harness.run_window(
            su, lambda: harness.requests_for(su, su.cell.rate, seconds, seed),
            trace=False)
    finally:
        moe.route = real
    checks, info = harness.run_checks(su, win, seed)
    return {"fault": fault, "program": checks["max_logit_gap"]["value"],
            "correct": harness.passed(checks), "program_readings": info}


if __name__ == "__main__":
    sys.exit(main())
