"""Serving launcher (PyTorch port of ``repro.launch.serve``): the RT-LM
scheduler over the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --policy rt-lm --n-requests 200 --beta 120,240 [--device cpu]

Runs the RT-LM ecosystem end to end on the smoke variant of the chosen
architecture, on the card unless ``--device cpu`` is given: offline
profiling (m_theta training, tau), then a Poisson request trace served
with real batched prefill and decode; prints the result as JSON.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import configs, resolve_device
from ..core import datagen, personas, scheduler as sched_lib, workload
from ..models import model as model_lib
from ..serving.engine import Request, ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--policy", default="rt-lm",
                    choices=tuple(sched_lib.POLICIES))
    ap.add_argument("--persona", default="dialogpt",
                    choices=personas.PERSONA_NAMES)
    ap.add_argument("--n-requests", type=int, default=200)
    ap.add_argument("--beta", default="120,240",
                    help="comma-separated per-minute arrival rates")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_smoke_config(args.arch)
    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    persona = personas.get_persona(args.persona)

    corpus = datagen.generate_corpus(
        datagen.VARIANCE_MIXES["normal"], args.n_requests * 2,
        seed=args.seed)
    train, test = datagen.train_test_split(corpus, train_frac=0.5)
    test = test[:args.n_requests]
    print(f"[serve] offline profiling ({len(train)} train tasks)...")
    profile = sched_lib.offline_profile(train, persona, epochs=40,
                                        seed=args.seed, device=device)
    betas = [int(b) for b in args.beta.split(",")]
    arrivals = workload.poisson_trace(len(test), betas=betas,
                                      seed=args.seed + 1)
    reqs = [Request(text=t.text, arrival=a, task_id=i)
            for i, (t, a) in enumerate(zip(test, arrivals))]

    policy = sched_lib.POLICIES[args.policy](
        persona, profile.policy_config())
    engine = ServingEngine(params, cfg, policy, profile,
                           max_new_tokens=args.max_new_tokens,
                           device=device)
    print(f"[serve] serving {len(reqs)} requests under {args.policy} "
          f"(arch={cfg.name})...")
    res = engine.serve(reqs)
    out = {k: v for k, v in res.items() if k != "tasks"}
    out["scheduler_overhead_ms_per_task"] = (
        1000.0 * res["scheduler_overhead_s"] / res["n_tasks"])
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
