"""Training launcher (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --smoke --steps 200 --batch 8 --seq 256 [--checkpoint DIR] \
        [--device cpu]

Trains the reduced smoke variant of the chosen architecture (or, with
``--no-smoke``, the published config, layer-wise rematerialised) on the
synthetic pipeline, on the card unless ``--device cpu`` is given.  One
``[train]`` header line, a step line every ``--log-every`` steps and a
final JSON line ``{"first_loss", "last_loss", "steps"}``, as the
reference prints them.  Sharded training (``--mesh``) is not ported.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from .. import configs, resolve_device
from ..models import model as model_lib
from ..training import checkpoint as ckpt_lib, data as data_lib
from ..training import optimizer as opt_lib, train_step as ts_lib
from ..tree import tree_paths


def main(argv=None, *, out: Optional[dict] = None) -> int:
    """``out``: a dict that receives the run's record (``cfg``, the
    trained ``params`` and ``opt_state``, every step's ``metrics`` as
    floats and its ``step_s``) for a caller that drives the launcher."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default=None,
                    help="not ported: sharded training")
    ap.add_argument("--optimizer", default=None,
                    choices=(None, "adamw", "adafactor"))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported to "
            "PyTorch yet (ROADMAP Queue 1 item 10)")
    device = resolve_device(args.device)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    opt_name = args.optimizer or opt_lib.default_optimizer_name(cfg)
    opt = opt_lib.make_optimizer(opt_name, args.lr, cfg)
    step_fn = ts_lib.make_train_step(cfg, opt, remat=not args.smoke)

    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    opt_state = opt.init(params)
    n_params = sum(p.numel() for _, p in tree_paths(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"optimizer={opt_name} mesh={args.mesh}")

    pipe = data_lib.SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch, seed=args.seed)
    t0 = time.time()
    losses, history, step_s = [], [], []
    for i, batch in enumerate(pipe.batches(args.steps, device=device)):
        batch = data_lib.add_modality_stub(batch, cfg, seed=i)
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        step_s.append(time.perf_counter() - ts)
        history.append(metrics)
        losses.append(metrics["loss"])
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"  step {i:5d} loss={losses[-1]:.4f} "
                  f"xent={metrics['xent']:.4f} "
                  f"grad_norm={metrics['grad_norm']:.3f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")

    if args.checkpoint:
        ckpt_lib.save(args.checkpoint, {"params": params}, step=args.steps)
        print(f"[train] checkpoint -> {args.checkpoint}")
    print(json.dumps({"first_loss": losses[0], "last_loss": losses[-1],
                      "steps": args.steps}))
    if out is not None:
        out.update(cfg=cfg, params=params, opt_state=opt_state,
                   metrics=history, step_s=step_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
