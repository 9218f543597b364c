"""The port's sharded paths on 4 CPU ranks (gloo) on a (2, 2) mesh
("data", "model"), against the unsharded port and the JAX package.

Three spawns (``torch.multiprocessing.spawn``, rank bodies in
``tests/torch_sharded_ranks.py``, a ``file://`` rendezvous under
``tmp_path``), float32 unless noted.  The weights and inputs are seeded
numpy arrays in the reference's tree layout, so the ranks start at once
and the parent computes the JAX side while they run:

(i)   ``lm_loss`` and one AdamW and one Adafactor train step of a dense
      smoke config whose 3 query heads (1 kv head) do not divide "model",
      with ``seq_parallel`` off and on, and of mamba2's smoke config, under
      ``make_policy(mesh)`` (FSDP on): loss, gradient norm, moments,
      statistics and parameters within 1e-5 relative of the unsharded
      step, the loss within 1e-5 of the JAX ``lm_loss`` on the same numpy
      weights;
(ii)  ``apply_moe_ep`` for kimi-k2's and mixtral's smoke layers
      (``capacity_factor=8``; mixtral cut to 3 experts, which do not divide
      "model", so one case each way of ``experts_sharded``), (B, S) in
      (4, 8) and (1, 1), train and serving layouts: within 1e-5 of
      ``apply_moe_local`` (the train layout's gradients too), and within
      the reference's own EP tolerances of the JAX layer (2e-3 on the
      output, 1e-4 on the aux loss, tests/test_moe_ep.py);
(iii) ``prefill`` + 4 ``decode_step``s in the serving layout
      (``make_policy(mesh, fsdp=False)``, ``serving=True``) of a dense smoke
      config with 1 kv head (the sequence-sharded cache) and of kimi-k2's
      with 4 kv heads (two a rank, each serving two query heads; the
      token-replicated MoE path): logits within 1e-5 of the unsharded
      port, within 1e-4 of JAX; and ``launch.train.main --mesh 2x2 --device
      cpu`` on seamless's bf16 smoke config (the encoder, cross attention,
      an untied head, a batch with frames): its lines, its first loss
      within 5e-2 of
      the unsharded launcher's (the reference's sharded-loss tolerance),
      and its checkpoint restored by an unsharded caller bit for bit.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_sharded_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

WORLD = 4


def start(name: str, tmp_path, inputs: dict):
    """Start the 4 ranks of ``ranks.<name>`` on ``inputs``; ``finish``
    joins them and returns rank 0's results."""
    workdir = str(tmp_path / name)
    os.makedirs(workdir)
    with open(os.path.join(workdir, "in.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = torch.multiprocessing.spawn(ranks.entry,
                                      args=(name, WORLD, workdir),
                                      nprocs=WORLD, join=False)
    return ctx, workdir


def finish(started) -> dict:
    ctx, workdir = started
    while not ctx.join():
        pass
    with open(os.path.join(workdir, "out.pkl"), "rb") as f:
        return pickle.load(f)


def numpy_params(init, seed: int):
    """Seeded float32 weights (0.02 standard normal) in the tree layout
    ``init(key)`` returns, made without running it."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (0.02 * rng.standard_normal(s.shape)).astype(s.dtype),
        jax.eval_shape(init, jax.random.PRNGKey(0)))


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# (i) training
# ---------------------------------------------------------------------------

TRAIN_CASES = [
    ("dense", "starcoder2-3b", dict(num_heads=3, num_kv_heads=1), False),
    ("dense_seq", "starcoder2-3b", dict(num_heads=3, num_kv_heads=1), True),
    ("ssm", "mamba2-1.3b", {}, False),
]


def test_sharded_train_steps_match_unsharded_and_jax(tmp_path):
    cases, jcfgs = [], {}
    for key, arch, repl, seq in TRAIN_CASES:
        repl = dict(repl, param_dtype="float32")
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **repl)
        params = numpy_params(lambda k: jm.init_params(k, jcfg), 3)
        rng = np.random.default_rng(4)
        toks = rng.integers(0, jcfg.vocab_size, (4, 17), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jcfgs[key] = jcfg
        cases.append({"key": key, "arch": arch, "replace": repl,
                      "seq_parallel": seq, "params": params,
                      "batch": batch})
    started = start("train_steps", tmp_path, {"cases": cases})
    jloss = {c["key"]: float(jax.jit(
        lambda p, b, cfg=jcfgs[c["key"]]: jm.lm_loss(p, cfg, b)[0])(
            c["params"], c["batch"])) for c in cases}
    out = finish(started)
    assert "Shard" in out[("dense", "adamw")]["placements"]
    for key, *_ in TRAIN_CASES:
        for name in ("adamw", "adafactor"):
            r = out[(key, name)]
            assert rel(r["loss"], r["loss_unsharded"]) < 1e-5, (key, r)
            assert rel(r["loss"], jloss[key]) < 1e-5, (key, r, jloss)
            assert rel(r["grad_norm"], r["grad_norm_unsharded"]) < 1e-5
            assert r["params"] < 1e-5, (key, name, r)
            assert r.get("moments", 0.0) < 1e-5, (key, r)
            assert r.get("stats", 0.0) < 1e-5, (key, r)


# ---------------------------------------------------------------------------
# (ii) expert-parallel MoE
# ---------------------------------------------------------------------------


def test_moe_ep_matches_local_and_jax(tmp_path):
    cases, jwant = [], {}
    for arch, repl in (("kimi-k2-1t-a32b", {}),
                       ("mixtral-8x22b", {"num_experts": 3})):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   capacity_factor=8.0, **repl)
        params = numpy_params(
            lambda k: jmoe.init_moe(k, jcfg, jnp.float32), 0)
        for B, S in ((4, 8), (1, 1)):
            rng = np.random.default_rng(B)
            x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
            cases.append({"key": (arch, B, S), "arch": arch,
                          "replace": dict(repl, capacity_factor=8.0),
                          "params": params, "x": x, "cfg": jcfg,
                          "w": rng.standard_normal(x.shape).astype(
                              np.float32)})
    started = start("moe_ep", tmp_path, {"cases": [
        {k: v for k, v in c.items() if k != "cfg"} for c in cases]})
    for c in cases:
        want, aux = jax.jit(lambda p, x, cfg=c["cfg"]: jmoe.apply_moe_local(
            p, x, cfg))(c["params"], c["x"])
        jwant[c["key"]] = (np.asarray(want), float(aux["moe_aux_loss"]))
    out = finish(started)
    assert {r["experts_sharded"] for r in out.values()} == {True, False}
    for (key, serving), r in out.items():
        want, aux = jwant[key]
        assert r["err"] < 1e-5, (key, serving, r["err"])
        assert rel(r["aux"], r["aux_unsharded"]) < 1e-5, (key, serving)
        assert r["drop"] == pytest.approx(r["drop_unsharded"], abs=1e-7)
        assert float(np.abs(r["out"] - want).max()) < 2e-3, (key, serving)
        assert abs(r["aux"] - aux) < 1e-4, (key, serving)
        assert r.get("grads", 0.0) < 1e-5, (key, serving, r)
    assert sum("grads" in r for r in out.values()) == 2


# ---------------------------------------------------------------------------
# (iii) serving layout and the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "seamless-m4t-large-v2", "--device", "cpu",
          "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1"]


def test_serving_layout_and_launcher_under_a_mesh(tmp_path, capsys):
    serve, jcfgs, n = [], {}, 4
    for key, arch, repl in (("dense_kv1", "starcoder2-3b",
                             dict(num_heads=4, num_kv_heads=1)),
                            ("moe", "kimi-k2-1t-a32b", dict(num_kv_heads=4))):
        repl = dict(repl, param_dtype="float32")
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **repl)
        rng = np.random.default_rng(6)
        jcfgs[key] = jcfg
        serve.append({
            "key": key, "arch": arch, "replace": repl,
            "params": numpy_params(lambda k: jm.init_params(k, jcfg), 5),
            "tokens": rng.integers(0, jcfg.vocab_size, (4, 12),
                                   dtype=np.int32),
            "decode": n, "next": [rng.integers(0, jcfg.vocab_size, (4, 1),
                                               dtype=np.int32)
                                  for _ in range(n)]})
    started = start("serve_and_launch", tmp_path,
                    {"serve": serve, "launch": LAUNCH + ["--mesh", "2x2"]})
    jlogits = {}
    for c in serve:
        jcfg = jcfgs[c["key"]]
        cache, last = jax.jit(lambda p, t: jm.prefill(
            p, jcfg, {"tokens": t}, 12 + n, jnp.float32))(c["params"],
                                                          c["tokens"])
        step = jax.jit(lambda p, cache, t: jm.decode_step(p, jcfg, cache, t))
        logits = [np.asarray(last)]
        for t in c["next"]:
            _, lg, cache = step(c["params"], cache, t)
            logits.append(np.asarray(lg))
        jlogits[c["key"]] = logits
    plain = {}
    assert ttrain.main(LAUNCH, out=plain) == 0
    capsys.readouterr()
    out = finish(started)
    assert "Shard(dim=1)" in out[("serve", "dense_kv1")]["cache"]
    for key, want in jlogits.items():
        r = out[("serve", key)]
        assert r["err"] < 1e-5, (key, r["err"])
        for g, w in zip(r["logits"], want):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
            assert (g.argmax(-1) == w.argmax(-1)).all()
        # the greedy tokens of the vocab-split logits (model._greedy)
        for tok, w in zip(r["next_tokens"], want[1:]):
            assert (tok[:, 0] == w.argmax(-1)).all()

    run = out["launch"]
    assert run["rc"] == 0 and run["step"] == 2 and run["bitwise"]
    assert run["dtype"] == "torch.bfloat16"
    lines = run["log"].strip().splitlines()
    assert lines[0].startswith("[train] arch=seamless-m4t-large-v2-smoke ")
    assert lines[0].endswith("optimizer=adamw mesh=2x2")
    assert sum(ln.startswith("  step ") for ln in lines) == 2
    res = json.loads(lines[-1])
    assert res["steps"] == 2 and res["first_loss"] == run["metrics"][0][
        "loss"]
    assert rel(res["first_loss"], plain["metrics"][0]["loss"]) < 5e-2
    assert np.isfinite(res["last_loss"])
