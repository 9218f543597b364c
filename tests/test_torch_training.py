"""PyTorch port: ``repro_torch.training`` against ``repro.training`` on
seeded inputs:

  * AdamW and Adafactor — one and three updates of a smoke parameter tree
    (the reference's tree carried across by ``params_from_numpy``) from
    seeded gradients: parameters within rtol 1e-5 / atol 1e-7 of the
    reference's but where the reference's gradient is below 1e-6 in some
    step (the first steps are ~lr·sign(g), which a float32 ordering
    difference flips where g ~ 0), and such misses in at most 1e-3 of the
    tree's entries; the optimizer state (AdamW's moments, Adafactor's
    statistics in the reference's stacked shapes, by the reference's
    leaf path) within the same tolerance;
  * Adafactor's update clip runs over the reference's stacked leaf, that
    is over every layer of a scanned group: a case where that clip
    decides the update (one layer's gradients 100×, the other's 0.01×),
    held to the reference, where a per-layer clip moves that layer over
    10 % less;
  * ``clip_by_global_norm`` and ``global_norm``;
  * ``SyntheticLMData`` batches and ``add_modality_stub`` arrays bit for
    bit;
  * checkpoints — a ``save`` / ``restore`` round trip of the port's tree
    (bf16, float32, int leaves, lists), the reference's mismatch
    ``ValueError`` word for word, and a checkpoint the JAX package wrote,
    read by the port in a process with no ``jax`` module and carried
    across by ``params_from_numpy``, giving the same logits.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_engine_setup as es  # noqa: E402
from test_torch_train_step import one_thread  # noqa: E402,F401

from repro import configs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-7
#: the near-zero rule: only entries whose reference gradient is below
#: this in some step may miss the tolerance ...
G_MIN = 1e-6
#: ... and they may be at most this share of the tree's entries
MAX_EXCLUDED = 1e-3

SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _cfg(name):
    cfg = es.cfg32(name)
    if name == "recurrentgemma-9b":
        # one superblock plus the (rec, rec) tail: prefix, scan and tail
        cfg = dataclasses.replace(cfg, num_layers=5)
    return cfg


def _grads(jp, seed):
    """Seeded gradients in the reference's tree, leaf scales spread over
    three decades so the factored statistics see uneven rows."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(jp)
    out = [np.float32(10.0 ** rng.uniform(-2, 1))
           * rng.standard_normal(a.shape).astype(np.float32)
           for a in leaves]
    return jax.tree.unflatten(treedef, out)


def _port(tree, cfg):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), cfg,
                                     "cpu")


def _run(cfg, name, jgrads_list):
    """One update a gradient tree in both packages; after each step, the
    two parameter trees (the reference's in the port's layout), the two
    states and the masks of entries whose gradient was at least G_MIN in
    every step so far, in the port's layout."""
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = _port(jp, cfg)
    jo = jopt.make_optimizer(name, 1e-2)
    to = topt.make_optimizer(name, 1e-2, cfg)
    js, ts = jo.init(jp), to.init(tp)
    keep, out = None, []
    for g in jgrads_list:
        u, js = jo.update(g, js, jp)
        jp = jopt.apply_updates(jp, u)
        tg = _port(g, cfg)
        u, ts = to.update(tg, ts, tp)
        topt.apply_updates(tp, u)
        big = ttree.tree_map(lambda a: a.abs().numpy() >= G_MIN, tg)
        keep = big if keep is None else ttree.tree_map(
            lambda a, b: a & b, keep, big)
        snap = lambda t: ttree.tree_map(torch.clone, t)  # noqa: E731
        out.append((snap(tp), _port(jp, cfg), snap(ts), js, keep))
    return out


@pytest.fixture(scope="module")
def trajectory():
    """(cfg name, optimizer) -> ``_run`` over three seeded gradient trees,
    computed once for the one-step and the three-step tests."""
    memo = {}

    def get(name, opt):
        if (name, opt) not in memo:
            cfg = _cfg(name)
            jp = jm.init_params(jax.random.PRNGKey(0), cfg)
            memo[name, opt] = cfg, _run(cfg, opt,
                                        [_grads(jp, s) for s in range(3)])
        return memo[name, opt]

    return get


def _assert_params(tp, want, keep):
    """Within RTOL / ATOL everywhere but near-zero-gradient entries (not
    ``keep``), which may miss it in at most MAX_EXCLUDED of the tree."""
    failed = total = 0
    for (path, a), (_, b), (_, k) in zip(ttree.tree_paths(tp),
                                         ttree.tree_paths(want),
                                         ttree.tree_paths(keep)):
        a, b = a.detach().numpy(), b.numpy()
        assert a.shape == b.shape, path
        off = np.abs(a - b) > ATOL + RTOL * np.abs(b)
        assert k[off].sum() == 0, path
        failed += int(off.sum())
        total += off.size
    assert failed <= MAX_EXCLUDED * total, (failed, total)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(trajectory, steps):
    cfg, run = trajectory("starcoder2-3b", "adamw")
    tp, want, ts, js, keep = run[steps - 1]
    _assert_params(tp, want, keep)
    assert int(ts["step"]) == int(js["step"]) == steps
    for k in ("mu", "nu"):
        for (_, a), (_, b) in zip(ttree.tree_paths(ts[k]),
                                  ttree.tree_paths(_port(js[k], cfg))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL)


def _flat_stats(js):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(js["stats"])[0]:
        keys = [p.key for p in path]
        out.setdefault("/".join(keys[:-1]), {})[keys[-1]] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("name", ["starcoder2-3b", "kimi-k2-1t-a32b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adafactor_matches_reference(trajectory, name, steps):
    """Scanned groups, a dense prefix (kimi-k2), a tail (recurrentgemma, 5
    layers) and the encoder's blocks (seamless): parameters, and the
    statistics per reference leaf in the reference's shapes."""
    _, run = trajectory(name, "adafactor")
    tp, want, ts, js, keep = run[steps - 1]
    _assert_params(tp, want, keep)
    jstats = _flat_stats(js)
    assert set(ts["stats"]) == set(jstats)
    for key, st in ts["stats"].items():
        assert set(st) == set(jstats[key]), key
        for k, v in st.items():
            assert tuple(v.shape) == jstats[key][k].shape, (key, k)
            np.testing.assert_allclose(v.numpy(), jstats[key][k],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{key}/{k}")


def test_adafactor_clip_is_group_wide():
    """Step 2's gradients are 100× step 1's on layer 0 and 0.01× on
    layer 1 of the scanned pair: layer 0's update RMS is ~1.3, layer 1's
    ~0.015, the pair's ~0.93 < 1 (the factored MLP matrices' ~1.16 and
    below).  The reference clips nothing; a per-layer clip, the
    reference's Adafactor run on layer 0 alone, shrinks layer 0's update
    by its own RMS."""
    cfg = _cfg("starcoder2-3b")
    jp0 = jm.init_params(jax.random.PRNGKey(0), cfg)
    g1 = _grads(jp0, 0)

    def scale_layers(g):
        g = jax.tree.map(lambda a: a, g)
        g["stack"]["scan0"] = jax.tree.map(
            lambda a: a * np.array([100.0, 0.01], np.float32).reshape(
                (2,) + (1,) * (a.ndim - 1)), g["stack"]["scan0"])
        return g

    grads = [g1, scale_layers(g1)]
    tp, want, _, _, keep = _run(cfg, "adafactor", grads)[-1]
    _assert_params(tp, want, keep)

    def layer0(tree):
        return jax.tree.map(lambda a: a[0], tree["stack"]["scan0"])

    jo = jopt.make_optimizer("adafactor", 1e-2)
    alone = layer0(jp0)
    state = jo.init(alone)
    for g in grads:
        u, state = jo.update(layer0(g), state, alone)
        alone = jopt.apply_updates(alone, u)
    start = layer0(jp0)
    for key in ("w_up", "w_down"):
        grouped = (want["layers"][0]["mlp"][key].numpy()
                   - np.asarray(start["mlp"][key]))
        per_layer = np.asarray(alone["mlp"][key]) - np.asarray(
            start["mlp"][key])
        ratio = float(np.abs(grouped).sum() / np.abs(per_layer).sum())
        assert ratio > 1.1, (key, ratio)


def test_clip_by_global_norm_matches_reference():
    cfg = _cfg("kimi-k2-1t-a32b")
    g = _grads(jm.init_params(jax.random.PRNGKey(0), cfg), 5)
    for max_norm in (1.0, 1e6):
        jc, jn = jopt.clip_by_global_norm(g, max_norm)
        tc, tn = topt.clip_by_global_norm(_port(g, cfg), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for (_, a), (_, b) in zip(ttree.tree_paths(tc),
                                  ttree.tree_paths(_port(jc, cfg))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0)
    small = {"a": torch.full((10,), 10.0)}
    clipped, norm = topt.clip_by_global_norm(small, 1.0)
    assert float(norm) == pytest.approx(10.0 * np.sqrt(10), rel=1e-5)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


def test_default_optimizer_and_unknown_name():
    for name in configs.ARCH_IDS:
        cfg = configs.get_config(name)
        assert topt.default_optimizer_name(cfg) == \
            jopt.default_optimizer_name(cfg)
    with pytest.raises(ValueError):
        topt.make_optimizer("sgd", 0.1, _cfg("starcoder2-3b"))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_match_reference(seed):
    kw = dict(vocab_size=300, seq_len=40, batch_size=3, seed=seed)
    jd, td = jdata.SyntheticLMData(**kw), tdata.SyntheticLMData(**kw)
    for k in ("table", "table_p", "phrases"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jd, k))
    n = 0
    for jb, tb in zip(jd.batches(3), td.batches(3, device="cpu")):
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        n += 1
    assert n == 3


@pytest.mark.parametrize("name", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2", "yi-6b"])
def test_modality_stub_matches_reference(name):
    cfg = configs.get_smoke_config(name)
    toks = np.zeros((2, 5), np.int32)
    for seed in (0, 7):
        jb = jdata.add_modality_stub({"tokens": jnp.asarray(toks)}, cfg,
                                     seed=seed)
        tb = tdata.add_modality_stub({"tokens": torch.from_numpy(toks)},
                                     cfg, seed=seed)
        assert set(tb) == set(jb)
        for k in set(tb) - {"tokens"}:
            assert tb[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tb[k].view(torch.int16).numpy(),
                np.asarray(jb[k]).view(np.int16))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    cfg = configs.get_smoke_config("mamba2-1.3b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = {"params": params, "step_count": torch.arange(3)}
    path = os.path.join(tmp_path, "ckpt")
    tckpt.save(path, tree, step=17, shard_bytes=1 << 16)
    assert len([f for f in os.listdir(path) if f.endswith(".npz")]) > 1
    restored, step = tckpt.restore(path, tree)
    assert step == 17
    assert isinstance(restored["params"]["layers"], list)
    for (pa, a), (pb, b) in zip(ttree.tree_paths(tree),
                                ttree.tree_paths(restored)):
        assert pa == pb and a.dtype == b.dtype
        assert torch.equal(a, b), pa
    # without ``like``: the stored tree, list items keyed by index
    raw, _ = tckpt.restore(path)
    assert torch.equal(raw["params"]["layers"]["1"]["mixer"]["A_log"],
                       params["layers"][1]["mixer"]["A_log"])


def test_checkpoint_mismatch_raises_as_reference(tmp_path):
    jpath, tpath = (os.path.join(tmp_path, d) for d in ("j", "t"))
    jckpt.save(jpath, {"a": jnp.zeros(3)})
    tckpt.save(tpath, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="mismatch") as want:
        jckpt.restore(jpath, {"b": jnp.zeros(3)})
    with pytest.raises(ValueError, match="mismatch") as got:
        tckpt.restore(tpath, {"b": torch.zeros(3)})
    assert str(got.value) == str(want.value)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jm_text = f.read()
    with open(os.path.join(tpath, "manifest.json")) as f:
        assert f.read() == jm_text


def test_checkpoint_written_by_the_reference(tmp_path):
    """A bf16 smoke model the JAX package saved: the port reads it in a
    process that imports no ``jax``, and the carried-across parameters
    give the same logits as the reference's tree carried across in
    memory (bit for bit) and as the reference (float32 tolerance)."""
    cfg = configs.get_smoke_config("starcoder2-3b")
    jp = jm.init_params(jax.random.PRNGKey(2), cfg)
    path = os.path.join(tmp_path, "ckpt")
    jckpt.save(path, {"params": jp}, step=5)
    code = ("import sys; from repro_torch.training import checkpoint as c; "
            f"t, s = c.restore({path!r}); "
            "assert 'jax' not in sys.modules and s == 5; "
            "print(len(t['params']['stack']['scan0']['attn']))")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["4"]
    tree, step = tckpt.restore(path)
    assert step == 5
    tp = convert.params_from_numpy(tree["params"], cfg, "cpu")
    ref = _port(jp, cfg)
    for (pa, a), (_, b) in zip(ttree.tree_paths(tp), ttree.tree_paths(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b), pa
    toks = np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    _, got = tm.prefill(tp, cfg, torch.from_numpy(toks), 20)
    _, same = tm.prefill(ref, cfg, torch.from_numpy(toks), 20)
    _, want = jm.prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, 20)
    assert torch.equal(got, same)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.15,
                               rtol=0.05)
