"""PyTorch port: the training step against ``repro.models.model.lm_loss``
and ``jax.grad``, on float32 smoke configs at the reference's smoke-test
size (B 2, S 24, the last label ignored; tests/test_models_smoke.py).
This file holds the dense configs, the loss-descent test and the
launchers; the other families are in ``test_torch_train_step_*.py``,
which share its helpers:

  * ``lm_loss`` — the loss and each metric (``xent``, ``tokens``,
    ``moe_aux_loss``, ``moe_drop_frac``) within 1e-5 relative of the
    reference's (1e-7 absolute where the reference's is ~0);
  * gradients — every leaf within 1e-4 × (|g_jax| + mean |g_jax|) of
    ``jax.grad``'s, elementwise (the reference's tree carried across by
    ``params_from_numpy``);
  * one AdamW ``train_step`` (clip 1.0, lr 1e-3) against the reference's
    clip, update and apply on its own gradients: parameters within rtol
    1e-5 / atol 1e-7, except entries whose reference gradient (after the
    clip: what its AdamW saw) is below 1e-6 (the first AdamW step is
    ~lr·sign(g), which a float32 ordering difference flips where g ~ 0),
    which may be at most 1e-3 of the tree's entries; ``grad_norm`` within
    1e-5 relative;
  * ``remat=True`` gives ``remat=False``'s loss and gradients bit for bit
    (the recomputed forward is the same computation);
  * the reference's ``test_loss_decreases_tiny_model``: 30 AdamW steps of
    the starcoder2-3b smoke model on ``SyntheticLMData``, the loss down
    by at least 0.5;
  * ``launch.train.main`` on the CPU prints its ``[train]`` lines and the
    final JSON line, writes a checkpoint the port restores; a ``--mesh``
    larger than the world raises, naming the ranks it needs, before
    anything is allocated; ``launch.serve.main`` serves a few
    requests on the CPU; both raise without a card unless given
    ``--device cpu``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_engine_setup as es  # noqa: E402

from repro.models import model as jm  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402

B, S = 2, 24
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STEP_RTOL, STEP_ATOL = 1e-5, 1e-7
G_MIN = 1e-6
MAX_EXCLUDED = 1e-3
LR = 1e-3

DENSE = ["starcoder2-3b", "yi-6b", "minitron-4b"]


# ---------------------------------------------------------------------------
# helpers shared by the test_torch_train_step_*.py files
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's torch work on one intra-op thread.  In a process that
    has run XLA, one of torch's CPU worker threads sometimes computes
    ``exp`` and ``sqrt`` of large float32 tensors to ~1e-4 relative (the
    other threads and a process without JAX to 1 ulp): seen in about one
    process in eight, it moves a whole worker's share of an AdamW update
    by 3e-4 of lr.  One thread keeps every comparison at float32 order
    differences; the tolerances are unchanged."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_batches(cfg, seed=0):
    """The reference smoke test's batch layout from a numpy seed: tokens,
    labels shifted by one with the last ignored, the modality stub."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], -np.ones((B, 1), np.int32)], 1)
    jb = jdata.add_modality_stub({"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)}, cfg)
    tb = tdata.add_modality_stub({"tokens": torch.from_numpy(toks),
                                  "labels": torch.from_numpy(labels)}, cfg)
    return jb, tb


def clone(tree):
    return ttree.tree_map(lambda t: t.detach().clone(), tree)


def grads_of(tp, cfg, tb, remat=False):
    """(loss, metrics, grads in the port's tree) on a fresh copy."""
    tp = clone(tp)
    paths = ttree.tree_paths(tp)
    leaves = [p.requires_grad_(True) for _, p in paths]
    loss, metrics = tm.lm_loss(tp, cfg, tb, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    tree = ttree.tree_map(lambda p: None, tp)
    for (path, _), g in zip(paths, grads):
        ttree.tree_set(tree, path, g)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree


@pytest.fixture(scope="module")
def family():
    """name -> dict(cfg, jp, tp, jb, tb, jloss, jmetrics, jgrads (the
    port's layout)), the reference's value_and_grad computed once."""
    memo = {}

    def get(name):
        if name not in memo:
            m = es.models(name)
            cfg, jp = m["cfg"], m["jp"]
            jb, tb = smoke_batches(cfg)
            (jl, jmet), jg = jax.value_and_grad(
                lambda p: jm.lm_loss(p, cfg, jb), has_aux=True)(jp)
            memo[name] = dict(
                cfg=cfg, jp=jp, tp=m["tp"], jb=jb, tb=tb, jloss=float(jl),
                jmetrics={k: float(v) for k, v in jmet.items()}, jg=jg,
                jgrads=convert.params_from_numpy(
                    jax.tree.map(np.asarray, jg), cfg, "cpu"))
        return memo[name]

    return get


def check_loss_and_grads(f):
    loss, metrics, grads = grads_of(f["tp"], f["cfg"], f["tb"])
    assert set(metrics) == set(f["jmetrics"])
    for k, want in f["jmetrics"].items():
        got = float(metrics[k])
        assert abs(got - want) <= LOSS_RTOL * abs(want) + 1e-7, (k, got,
                                                                 want)
    assert float(loss) == float(metrics["loss"])
    for (path, g), (_, w) in zip(ttree.tree_paths(grads),
                                 ttree.tree_paths(f["jgrads"])):
        w = w.numpy()
        assert g.shape == w.shape, path
        err = np.abs(g.numpy() - w)
        lim = GRAD_RTOL * (np.abs(w) + np.abs(w).mean())
        assert (err <= lim).all(), (path, float((err - lim).max()))


def check_train_step(f):
    cfg = f["cfg"]
    tp = clone(f["tp"])
    opt = topt.make_optimizer("adamw", LR, cfg)
    step = tts.make_train_step(cfg, opt, remat=False, clip_norm=1.0)
    tp, state, metrics = step(tp, opt.init(tp), f["tb"])
    jo = jopt.make_optimizer("adamw", LR)
    g, norm = jopt.clip_by_global_norm(f["jg"], 1.0)
    u, _ = jo.update(g, jo.init(f["jp"]), f["jp"])
    want = convert.params_from_numpy(
        jax.tree.map(np.asarray, jopt.apply_updates(f["jp"], u)), cfg, "cpu")
    assert int(state["step"]) == 1
    assert float(metrics["grad_norm"]) == pytest.approx(float(norm),
                                                        rel=1e-5)
    # the gradient the reference's AdamW saw: after the clip
    seen = convert.params_from_numpy(jax.tree.map(np.asarray, g), cfg,
                                     "cpu")
    failed = total = 0
    for (path, a), (_, b), (_, gj) in zip(ttree.tree_paths(tp),
                                          ttree.tree_paths(want),
                                          ttree.tree_paths(seen)):
        a, b, gj = a.detach().numpy(), b.numpy(), gj.numpy()
        off = np.abs(a - b) > STEP_ATOL + STEP_RTOL * np.abs(b)
        assert (np.abs(gj[off]) < G_MIN).all(), path
        failed += int(off.sum())
        total += off.size
    assert failed <= MAX_EXCLUDED * total, (failed, total)


def check_remat(f):
    l0, m0, g0 = grads_of(f["tp"], f["cfg"], f["tb"], remat=False)
    l1, m1, g1 = grads_of(f["tp"], f["cfg"], f["tb"], remat=True)
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for (path, a), (_, b) in zip(ttree.tree_paths(g0), ttree.tree_paths(g1)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the dense configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_lm_loss_and_grads(family, name):
    check_loss_and_grads(family(name))


@pytest.mark.parametrize("name", DENSE)
def test_train_step(family, name):
    check_train_step(family(name))


@pytest.mark.parametrize("name", DENSE)
def test_remat_equals_no_remat(family, name):
    check_remat(family(name))


def test_loss_decreases_tiny_model():
    cfg = tconfigs.get_smoke_config("starcoder2-3b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = topt.make_optimizer("adamw", 3e-3, cfg)
    step = tts.make_train_step(cfg, opt, remat=False)
    state = opt.init(params)
    pipe = tdata.SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=64,
                                 batch_size=8, seed=0)
    losses = []
    for batch in pipe.batches(30, device="cpu"):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert not any(np.isnan(losses))


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def test_train_launcher_on_cpu(tmp_path, capsys):
    path = os.path.join(tmp_path, "ckpt")
    out = {}
    rc = ttrain.main(["--arch", "llava-next-mistral-7b", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--log-every", "1", "--checkpoint", path], out=out)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[train] arch=llava-next-mistral-7b-smoke ")
    assert "optimizer=adamw mesh=None" in lines[0]
    assert sum(ln.startswith("  step ") for ln in lines) == 3
    res = json.loads(lines[-1])
    assert set(res) == {"first_loss", "last_loss", "steps"}
    assert res["steps"] == 3 and np.isfinite(res["last_loss"])
    assert res["first_loss"] == out["metrics"][0]["loss"]
    restored, step = tckpt.restore(path, {"params": out["params"]})
    assert step == 3
    for (p, a), (_, b) in zip(ttree.tree_paths(out["params"]),
                              ttree.tree_paths(restored["params"])):
        assert torch.equal(a, b), p


def test_train_launcher_refuses_a_mesh_and_needs_a_card(monkeypatch):
    # a mesh larger than the world (one process, no torchrun environment)
    # is refused before anything is allocated
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    allocated = []
    monkeypatch.setattr(tm, "init_params",
                        lambda *a, **k: allocated.append(1))
    with pytest.raises(RuntimeError, match="needs 8 ranks, have 1"):
        ttrain.main(["--arch", "yi-6b", "--mesh", "2x4", "--device", "cpu"])
    assert not allocated
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "yi-6b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "yi-6b", "--n-requests", "2"])


def test_serve_launcher_on_cpu(capsys):
    rc = tserve.main(["--arch", "starcoder2-3b", "--device", "cpu",
                      "--n-requests", "6", "--max-new-tokens", "4"])
    assert rc == 0
    text = capsys.readouterr().out
    assert text.startswith("[serve] offline profiling (6 train tasks)...")
    res = json.loads(text[text.index("\n{") + 1:])
    assert res["n_tasks"] == 6 and len(res["completion_order"]) == 6
    assert res["device"] == "cpu" and "tasks" not in res
    assert res["scheduler_overhead_ms_per_task"] >= 0
