#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port on the card.

    python3 rtbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up: the kernels built into the
checkout's ``build/`` (the first run of a checkout builds them), the
weights made from the seed on the card, m_theta trained, one short warm-up
serve.  The window: one ``serve()`` of an open-loop schedule that spans
``--seconds`` of the engine clock.  Then the metrics (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer ones, from the
engine's counters, an ``Observability`` bundle and the profiler) and the
check that decides ``correct``.  The last line of standard output is the
result as one JSON object; the numbers compared, each with its limit, are
the last lines of standard error and the last key of that object.

Exits 2 without a result where there is no card, or fewer cards than the
cell asks for, and 3 where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "rtbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))


def say(msg: str) -> None:
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    cell = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        say("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        say(f"the cell asks for {cell.chips} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    if cell.rate is None:
        say(f"no knee recorded for {args.workload}'s engine row")
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda"), T_START, say=say)
    bad = harness.forbidden_modules()
    if bad:
        say("loaded modules of JAX or the JAX package: " + ", ".join(bad))
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
