"""Training launcher (PyTorch port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --smoke --steps 200 --batch 8 --seq 256 [--checkpoint DIR] \
        [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch yi-6b --mesh 2x2 [--device cpu]

Trains the reduced smoke variant of the chosen architecture (or, with
``--no-smoke``, the published config, layer-wise rematerialised) on the
synthetic pipeline, on the card unless ``--device cpu`` is given.  One
``[train]`` header line, a step line every ``--log-every`` steps and a
final JSON line ``{"first_loss", "last_loss", "steps"}``, as the
reference prints them.

``--mesh RxC`` (or ``PxRxC``) trains sharded, one process a device: the
process group comes from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``; gloo for ``--device
cpu``, NCCL for the card) or from the caller, who may have initialised it
already; without either the world is one process.  The launcher builds
the mesh (axes ("data", "model") or ("pod", "data", "model")), the
reference's policy (``make_policy(mesh)``: FSDP on), and lays the
parameters, optimizer state and batches out by it; rank 0 prints, and
writes the checkpoint, which an unsharded run restores.  A mesh larger
than the world raises before anything is allocated.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from .. import configs, resolve_device
from ..models import model as model_lib
from ..sharding import context as shctx, policy as policy_lib
from . import mesh as mesh_lib
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
                    help="e.g. 2x4 => (data=2, model=4); default: no mesh")
    ap.add_argument("--optimizer", default=None,
                    choices=(None, "adamw", "adafactor"))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    shape = (tuple(int(n) for n in args.mesh.split("x")) if args.mesh
             else None)
    if shape is not None:
        world = (dist.get_world_size() if dist.is_initialized()
                 else int(os.environ.get("WORLD_SIZE", "1")))
        if world < math.prod(shape):
            raise RuntimeError(
                f"--mesh {args.mesh} needs {math.prod(shape)} ranks, have "
                f"{world}: start one process a device, e.g. torchrun "
                f"--nproc-per-node {math.prod(shape)}")
    device = resolve_device(args.device)
    own_group = False
    mesh = policy = None
    if shape is not None:
        own_group = _init_process_group(device)
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        mesh = mesh_lib.make_mesh(shape, axes, device)
        policy = policy_lib.make_policy(mesh)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    opt_name = args.optimizer or opt_lib.default_optimizer_name(cfg)
    opt = opt_lib.make_optimizer(opt_name, args.lr, cfg)
    step_fn = ts_lib.make_train_step(cfg, opt, remat=not args.smoke)

    params = model_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    if policy is not None:
        params = policy.distribute(params, policy.param_shardings(params))
    opt_state = opt.init(params)
    if policy is not None:
        opt_state = policy.distribute(opt_state,
                                      policy.opt_shardings(opt_state))
    n_params = sum(p.numel() for _, p in tree_paths(params))
    if lead:
        print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
              f"optimizer={opt_name} mesh={args.mesh}")

    pipe = data_lib.SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        batch_size=args.batch, seed=args.seed)
    t0 = time.time()
    losses, history, step_s = [], [], []
    scope = (shctx.use_policy(policy) if policy is not None
             else contextlib.nullcontext())
    try:
        with scope:
            for i, batch in enumerate(pipe.batches(args.steps,
                                                   device=device)):
                batch = data_lib.add_modality_stub(batch, cfg, seed=i)
                if policy is not None:
                    batch = policy.distribute(
                        batch, policy.batch_shardings(batch))
                ts = time.perf_counter()
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                step_s.append(time.perf_counter() - ts)
                history.append(metrics)
                losses.append(metrics["loss"])
                if lead and (i % args.log_every == 0
                             or i == args.steps - 1):
                    print(f"  step {i:5d} loss={losses[-1]:.4f} "
                          f"xent={metrics['xent']:.4f} "
                          f"grad_norm={metrics['grad_norm']:.3f} "
                          f"({(time.time()-t0)/(i+1):.2f}s/step)")

        if args.checkpoint:
            ckpt_lib.save(args.checkpoint, {"params": params},
                          step=args.steps)
            if lead:
                print(f"[train] checkpoint -> {args.checkpoint}")
        if lead:
            print(json.dumps({"first_loss": losses[0],
                              "last_loss": losses[-1],
                              "steps": args.steps}))
        if out is not None:
            out.update(cfg=cfg, params=params, opt_state=opt_state,
                       metrics=history, step_s=step_s)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


def _init_process_group(device: torch.device) -> bool:
    """The process group of a ``--mesh`` run, unless the caller made one:
    from the ``torchrun`` environment, or a world of one.  gloo on the
    CPU, NCCL on the card (each rank on card ``LOCAL_RANK``).  Returns
    whether this call made it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


if __name__ == "__main__":
    raise SystemExit(main())
