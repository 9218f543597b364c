"""Production-mesh dry run of one (arch x shape x mesh) combination
(PyTorch port of ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \
        --shape train_4k [--multi-pod] [--out results.json] [--no-fsdp]

Proves the distribution config is coherent without hardware: with no
process group in place it starts a fake one (``torch.distributed``'s
``fake`` backend) of 256 ranks, or 512 with ``--multi-pod``, and this
process plays rank 0; it builds the production mesh on it, lays fake
stand-ins of the step's inputs (``launch.specs``: no allocation) out as
DTensors under the reference's policy, runs the step once under
``FakeTensorMode`` inside ``op_cost.OpCost`` and ``MemTracker``, and
prints the resident bytes a card needs (fits 80 GB?), the per-card flops
and HBM bytes, the H100 roofline (``launch.analysis``) and the collective
schedule.  Collectives on the fake backend return at once; every op runs
on rank 0's local shards.

It allocates nothing and needs no card: the stand-ins are fake tensors on
the CPU, which is why this entry point, unlike the port's others, does
not default to the card (the reference's dry run also runs on host
placeholder devices).  A CPU-only torch cannot index a fake ``cuda``
tensor (``x[..., None]`` raises "not linked with support for cuda
devices"), so the mesh is a CPU one; the one redistribution DTensor
issues differently on a CPU mesh, Shard(i) -> Shard(j), is issued as a
CUDA mesh issues it (``card_collectives``).  ``dry_step`` runs one step
of any shape under any policy, on fake tensors of any device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

import torch.distributed as dist

from .. import configs
from ..sharding import context as shctx, policy as policy_lib
from . import analysis, mesh as mesh_lib, op_cost, specs


def ensure_world(n: int) -> None:
    """A process group of at least ``n`` ranks: the caller's, or a fake
    one of ``n`` ranks in which this process is rank 0."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


@contextlib.contextmanager
def card_collectives():
    """DTensor's Shard(i) -> Shard(j) as a CUDA mesh moves it: one
    ``_dtensor.shard_dim_alltoall``.  On a CPU mesh DTensor takes gloo's
    fallback instead, an all-gather of the whole tensor and a chunk, which
    moves mesh-axis-size times the all-to-all's bytes (16x on the
    production mesh).  Under a fake mode the op runs only its registered
    shape function, so this serves the dry run on any mesh."""
    import torch
    from torch.distributed.tensor import placement_types
    cpu_path = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = cpu_path


def lay_out(policy, shape, args, in_specs):
    """``args`` as DTensors laid out by ``in_specs`` (``pos`` and
    ``slot_pos`` of a decode cache stay plain, as ``model.prefill`` leaves
    them)."""
    if shape.kind == "decode":
        params, cache, token = args
        cache = dict(cache, layers=policy.distribute(
            cache["layers"], in_specs[1]["layers"]))
        return (policy.distribute(params, in_specs[0]), cache,
                policy.distribute_one(token, in_specs[2]))
    return tuple(policy.distribute(a, s) for a, s in zip(args, in_specs))


def dry_step(cfg, shape, policy, device="cpu"):
    """One step of ``shape.kind`` on fake inputs laid out by ``policy``:
    returns (cost, memory summary, roofline, seconds to build the inputs,
    seconds of the fake step)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.perf_counter()
    args, meta = specs.input_specs(cfg, shape, device)
    in_specs = specs.step_shardings(cfg, shape, policy, args)
    mode = meta["fake_mode"]
    with mode:
        args = lay_out(policy, shape, args, in_specs)
    step = specs.make_step_fn(cfg, shape)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tracker = MemTracker()
    tracker.track_external(*args)
    counter = op_cost.OpCost()
    with mode, card_collectives(), shctx.use_policy(policy), counter, \
            tracker:
        out = step(*args)
    t_step = time.perf_counter() - t0
    mem = analysis.memory_summary(tracker, args, out)
    roof = analysis.analyze(counter.cost, cfg, shape,
                            math.prod(policy.mesh.shape))
    return counter.cost, mem, roof, t_build, t_step


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            fsdp: bool = True, seq_parallel: bool = False,
            serving: bool = False, verbose: bool = True) -> dict:
    cfg = configs.get_config(arch)
    shape = configs.INPUT_SHAPES[shape_name]
    ok, reason = configs.shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    ensure_world(512 if multi_pod else 256)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    policy = policy_lib.make_policy(mesh, fsdp=fsdp)
    policy.seq_parallel = seq_parallel
    policy.serving = serving
    _, mem, roof, t_build, t_step = dry_step(cfg, shape, policy)
    coll = {"bytes_by_kind": roof.collective_by_kind,
            "counts": roof.collective_counts,
            "total_bytes": roof.collective_bytes}
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "fsdp": fsdp, "seq_parallel": seq_parallel, "serving": serving,
        "status": "ok",
        "mesh": {"shape": list(mesh.shape),
                 "axes": list(mesh.mesh_dim_names)},
        # the reference's lower / compile: here building and laying out
        # the stand-ins, and the one fake step
        "lower_s": round(t_build, 1), "compile_s": round(t_step, 1),
        "memory": mem,
        "roofline": roof.to_dict(),
        "collectives": coll,
    }
    if verbose:
        gb = mem["resident_bytes_per_device"] / 1e9
        fits = mem["resident_bytes_per_device"] <= analysis.HBM_BYTES
        print(f"[dryrun] {arch} x {shape_name} "
              f"mesh={tuple(mesh.shape)} fsdp={fsdp}")
        print(f"  build {t_build:.1f}s  fake step {t_step:.1f}s")
        print(f"  memory: {json.dumps(mem)}")
        print(f"  resident/device: {gb:.2f} GB "
              f"({'FITS' if fits else 'EXCEEDS'} "
              f"{analysis.HBM_BYTES / 1e9:.0f} GB {analysis.CARD})")
        print(f"  cost: flops/dev={roof.flops:.3e} "
              f"bytes/dev={roof.hbm_bytes:.3e}")
        print(f"  roofline (H100 SXM: "
              f"{analysis.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
              f"{analysis.HBM_BW / 1e12:.2f} TB/s HBM, "
              f"{analysis.collective_bandwidth(roof.n_devices) / 1e9:.0f} "
              f"GB/s collective): compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"-> {roof.dominant}-bound")
        print(f"  useful-FLOPs ratio (model/counted): "
              f"{roof.useful_flops_ratio:.3f}")
        print("  collectives: " + ", ".join(
            f"{k}:{v:g} ({coll['bytes_by_kind'][k]/2**20:.1f} MiB)"
            for k, v in coll["counts"].items() if v))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--shape", required=True,
                    choices=tuple(configs.INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--serving-layout", dest="serving",
                    action="store_true")
    ap.add_argument("--out", default=None, help="write JSON result here")
    args = ap.parse_args(argv)

    result = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                     fsdp=args.fsdp, seq_parallel=args.seq_parallel,
                     serving=args.serving)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if result["status"] == "skipped":
        print(f"[dryrun] SKIPPED {args.arch} x {args.shape}: "
              f"{result['reason']}")
    return 0 if result["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
