"""Orchestrate the full dry-run matrix: 10 archs x 4 shapes x meshes
(PyTorch port of ``repro.launch.dryrun_all``).

Each combination runs in-process, one after another, on one fake world
(``dryrun.ensure_world``: 256 ranks, 512 with ``--multi-pod``); results
land in ``<outdir>/<arch>.<shape>.<mesh>.json`` with one summary line a
combination.  Skipped combinations (long_500k on quadratic-attention
archs) are recorded with their reason, and an error in one combination is
recorded with its traceback while the run goes on.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all \
        [--outdir build/dryrun] [--archs a,b] [--shapes s1,s2]
        [--multi-pod] [--skip-existing]
"""

import argparse
import json
import os
import time
import traceback

from .. import configs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="build/dryrun")
    ap.add_argument("--archs", default=",".join(configs.ARCH_IDS))
    ap.add_argument("--shapes", default=",".join(configs.INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--serving-layout", dest="serving", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from .dryrun import run_one

    os.makedirs(args.outdir, exist_ok=True)
    suffix = ("multipod" if args.multi_pod else "pod") + \
        ("" if args.fsdp else ".nofsdp") + \
        (f".{args.tag}" if args.tag else "")
    rows = []
    for arch in args.archs.split(","):
        for shape in args.shapes.split(","):
            out = os.path.join(args.outdir, f"{arch}.{shape}.{suffix}.json")
            if args.skip_existing and os.path.exists(out):
                print(f"[all] skip existing {out}")
                continue
            t0 = time.time()
            try:
                res = run_one(arch, shape, multi_pod=args.multi_pod,
                              fsdp=args.fsdp,
                              seq_parallel=args.seq_parallel,
                              serving=args.serving, verbose=False)
            except Exception as e:       # noqa: BLE001 — record and go on
                res = {"arch": arch, "shape": shape, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            res["wall_s"] = round(time.time() - t0, 1)
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
            status = res["status"]
            extra = ""
            if status == "ok":
                r = res["roofline"]
                gb = res["memory"]["resident_bytes_per_device"] / 1e9
                extra = (f"dom={r['dominant']} "
                         f"comp={r['compute_s']*1e3:.0f}ms "
                         f"mem={r['memory_s']*1e3:.0f}ms "
                         f"coll={r['collective_s']*1e3:.0f}ms "
                         f"{gb:.1f}GB/dev")
            elif status == "error":
                extra = res["error"][:120]
            print(f"[all] {arch:24s} {shape:12s} {status:7s} "
                  f"{res['wall_s']:6.1f}s {extra}", flush=True)
            rows.append(res)
    n_ok = sum(r["status"] == "ok" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    print(f"[all] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
