"""Rank bodies of ``tests/test_torch_sharded.py`` (not a test module).

Each function runs in one of 4 CPU processes (gloo) on a (2, 2) mesh
("data", "model"), started by ``torch.multiprocessing.spawn``; it imports
torch and the port only (the parent test holds the JAX side).  Inputs
come from ``<dir>/in.pkl``, written by the parent; rank 0 writes its
results to ``<dir>/out.pkl``.  Every collective (``full_tensor``) runs on
all ranks.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import os
import pickle
import sys

import torch
import torch.distributed as dist


def entry(rank: int, name: str, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "pg"),
        rank=rank, world_size=world)
    try:
        from repro_torch.launch import mesh as mesh_lib
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
        with open(os.path.join(workdir, "in.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = globals()[name](mesh, inputs, workdir)
        if rank == 0:
            with open(os.path.join(workdir, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def err(a, b) -> float:
    """max |a - b| over max |b| (float32)."""
    a, b = full(a).float(), full(b).float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _tree_err(got, want, mask=None) -> float:
    from repro_torch.tree import tree_paths
    worst = 0.0
    for (path, a), (_, b) in zip(tree_paths(got), tree_paths(want)):
        a, b = full(a).float(), b.float()
        d = (a - b).abs()
        if mask is not None:
            d = d * mask[path]
        worst = max(worst, float(d.max() / b.abs().max().clamp(min=1e-30)))
    return worst


# ---------------------------------------------------------------------------
# (i) training: lm_loss, one AdamW and one Adafactor step
# ---------------------------------------------------------------------------


def train_steps(mesh, inputs, workdir):
    from repro_torch import configs
    from repro_torch.models import convert, model as model_lib
    from repro_torch.sharding import context as shctx, policy as policy_lib
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts_lib
    from repro_torch.tree import tree_map, tree_paths

    out = {}
    for case in inputs["cases"]:
        cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                                  **case["replace"])
        params = convert.params_from_numpy(case["params"], cfg, "cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        policy = policy_lib.make_policy(mesh)
        policy.seq_parallel = case["seq_parallel"]
        for name in ("adamw", "adafactor"):
            opt = opt_lib.make_optimizer(name, 1e-3, cfg)
            step = ts_lib.make_train_step(cfg, opt, remat=False)
            p0 = copy.deepcopy(params)
            s0 = opt.init(p0)
            p0, s0, m0 = step(p0, s0, batch)
            p1 = copy.deepcopy(params)
            p1 = policy.distribute(p1, policy.param_shardings(p1))
            s1 = opt.init(p1)
            s1 = policy.distribute(s1, policy.opt_shardings(s1))
            with shctx.use_policy(policy):
                b1 = policy.distribute(batch, policy.batch_shardings(batch))
                p1, s1, m1 = step(p1, s1, b1)
            rec = {"loss": float(m1["loss"]), "loss_unsharded":
                   float(m0["loss"]), "grad_norm": float(m1["grad_norm"]),
                   "grad_norm_unsharded": float(m0["grad_norm"]),
                   "placements": str(tree_paths(p1)[1][1].placements)}
            if name == "adamw":
                rec["moments"] = max(_tree_err(s1[k], s0[k])
                                     for k in ("mu", "nu"))
                # where |g| is within 100 eps of 0, the first AdamW
                # update g / (|g| + eps) is set by rounding-level
                # differences of g; elsewhere it is held as the rest
                big = tree_map(lambda mu: (mu.abs() / 0.1 > 1e-6).float(),
                               s0["mu"])
                rec["params"] = _tree_err(p1, p0, dict(tree_paths(big)))
            else:
                rec["params"] = _tree_err(p1, p0)
                rec["stats"] = _tree_err(s1["stats"], s0["stats"])
            out[(case["key"], name)] = rec
    return out


# ---------------------------------------------------------------------------
# (ii) the expert-parallel MoE layer
# ---------------------------------------------------------------------------


def moe_ep(mesh, inputs, workdir):
    from repro_torch import configs
    from repro_torch.models import convert, moe
    from repro_torch.sharding import context as shctx, policy as policy_lib
    from repro_torch.tree import tree_map_with_path, tree_paths

    out = {}
    for case in inputs["cases"]:
        cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                                  **case["replace"])
        params = tree_map_with_path(
            lambda a, _: convert.tensor_from_numpy(a, "cpu"), case["params"])
        x = torch.from_numpy(case["x"])
        want, aux_want = moe.apply_moe_local(params, x, cfg)
        for serving in (False, True):
            policy = policy_lib.make_policy(mesh)
            policy.serving = serving
            dp = policy.distribute({"moe": params}, policy.param_shardings(
                {"moe": params}))["moe"]
            with torch.no_grad(), shctx.use_policy(policy):
                dx = policy.distribute_one(x, policy.spec(
                    x.shape, ("batch", None, None)))
                got, aux = moe.apply_moe(dp, dx, cfg)
            rec = {"out": full(got).numpy(), "err": err(got, want),
                   "aux": float(full(aux["moe_aux_loss"])),
                   "aux_unsharded": float(aux_want["moe_aux_loss"]),
                   "drop": float(full(aux["moe_drop_frac"])),
                   "drop_unsharded": float(aux_want["moe_drop_frac"]),
                   "experts_sharded": cfg.num_experts % 2 == 0}
            if not serving and x.shape[0] > 1:
                # gradients of the train layout: x and every weight
                w = torch.from_numpy(case["w"])

                def grads(p, xx, ctx):
                    leaves = [xx] + [v for _, v in tree_paths(p)]
                    for t in leaves:
                        t.requires_grad_(True)
                    with ctx:
                        o, a = moe.apply_moe(p, xx, cfg)
                        loss = (o * w).sum() + 10.0 * a["moe_aux_loss"]
                        return torch.autograd.grad(loss, leaves)
                g0 = grads(copy.deepcopy(params), x.clone(),
                           contextlib.nullcontext())
                dx = policy.distribute_one(x, policy.spec(
                    x.shape, ("batch", None, None)))
                g1 = grads(dp, dx, shctx.use_policy(policy))
                rec["grads"] = max(err(a, b) for a, b in zip(g1, g0))
            out[(case["key"], serving)] = rec
    return out


# ---------------------------------------------------------------------------
# (iii) serving-layout prefill + decode, and the launcher under a mesh
# ---------------------------------------------------------------------------


def serve_and_launch(mesh, inputs, workdir):
    from repro_torch import configs
    from repro_torch.launch import train as train_lib
    from repro_torch.models import convert, model as model_lib
    from repro_torch.sharding import context as shctx, policy as policy_lib
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.tree import tree_map, tree_paths

    out = {}
    for case in inputs["serve"]:
        cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]),
                                  **case["replace"])
        params = convert.params_from_numpy(case["params"], cfg, "cpu")
        tokens = torch.from_numpy(case["tokens"])
        S, n = tokens.shape[1], case["decode"]
        cache, last = model_lib.prefill(params, cfg, tokens, S + n,
                                        torch.float32)
        want = [last]
        tok = case["next"]      # (the same decode inputs in every run)
        for t in tok:
            want.append(model_lib.decode_step(params, cfg, cache,
                                              torch.from_numpy(t))[1])
        policy = dataclasses.replace(
            policy_lib.make_policy(mesh, fsdp=False), serving=True)
        dp = policy.distribute(params, policy.param_shardings(params))
        with shctx.use_policy(policy):
            dcache, dlast = model_lib.prefill(
                dp, cfg, policy.distribute_one(
                    tokens, policy.spec(tokens.shape, ("batch", None))),
                S + n, torch.float32)
            got, nxt = [dlast], []
            for t in tok:
                n_tok, lg = model_lib.decode_step(
                    dp, cfg, dcache, torch.from_numpy(t))
                got.append(lg)
                nxt.append(full(n_tok).numpy())
        got = [full(g) for g in got]
        out[("serve", case["key"])] = {
            "logits": [g.numpy() for g in got], "next_tokens": nxt,
            "err": max(err(a, b) for a, b in zip(got, want)),
            "cache": str(dcache["layers"][0]["k"].placements)}

    ckpt = os.path.join(workdir, "ckpt")
    log = io.StringIO()
    rec = {}
    with contextlib.redirect_stdout(log):
        rc = train_lib.main(inputs["launch"] + ["--checkpoint", ckpt],
                            out=rec)
    trained = tree_map(full, rec["params"])
    if dist.get_rank() == 0:
        like = tree_map(lambda t: torch.empty(0), trained)
        restored, step = ckpt_lib.restore(ckpt, {"params": like})
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_paths(trained), tree_paths(restored["params"])))
        out["launch"] = {"rc": rc, "log": log.getvalue(), "step": step,
                         "bitwise": same, "metrics": rec["metrics"],
                         "dtype": str(tree_paths(trained)[0][1].dtype)}
    return out


if __name__ == "__main__":      # pragma: no cover
    sys.exit("imported by tests/test_torch_sharded.py")
