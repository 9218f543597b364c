"""PyTorch port: the attention-only model families against
``repro.models.model``, on float32 smoke configs — the MoE stacks
(kimi-k2-1t-a32b: a dense prefix layer, then MoE layers with a shared
expert; mixtral-8x22b: MoE with a sliding window) and the dense
sliding-window stack (h2o-danube-3-4b, window 64):

  * weight bridge — ``params_from_numpy`` lays the reference's
    ``prefix{i}`` / ``scan0`` groups out in ``layer_kinds`` order, every
    leaf bit for bit, MoE routers kept float32 under a cast;
  * the bulk lane's ring path — ``prefill`` of 80-token prompts (past the
    window, so the ring wraps and the windowed attention runs) and
    ``decode_step`` on the wrapped ring: logits within 1e-4, greedy tokens,
    ``pos`` and ``slot_pos`` identical; and ``generate``'s greedy tokens
    identical to the JAX ``generate``;
  * kimi-k2 on the paged path — two fused ragged prefill iterations and a
    paged decode window (``use_kernels`` False: the reference's plain
    path; True: the kernels' plain versions on CPU tensors) against the
    JAX paged path: logits within a stated tolerance, greedy tokens
    identical, pages within two bf16 ulps (ROADMAP Queue 3 entry 1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_engine_setup as es  # noqa: E402
from test_torch_model import _close, _packed  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import generate as jgen  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import generate as tgen  # noqa: E402

NAMES = ["kimi-k2-1t-a32b", "mixtral-8x22b", "h2o-danube-3-4b"]
S = 80                      # prompt length, past the smoke window of 64


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(name):
        if name not in memo:
            m = es.models(name)
            memo[name] = (m["cfg"], m["jp"], m["tp"])
        return memo[name]

    return get


def _prompts(cfg, B, n, seed=1):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("name", ["kimi-k2-1t-a32b", "mixtral-8x22b"])
def test_params_from_numpy_follows_the_stack_pattern(name):
    cfg = configs.get_smoke_config(name)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1),
                                                   cfg))
    pat, n, prefix, _ = jt.stack_pattern(cfg)
    assert tt.layer_kinds(cfg) == prefix + pat * n
    tp = convert.params_from_numpy(tree, cfg, "cpu")
    want = ([tree["stack"][f"prefix{i}"] for i in range(len(prefix))]
            + [jax.tree.map(lambda a, r=r: a[r], tree["stack"]["scan0"])
               for r in range(n)])
    assert len(tp["layers"]) == len(want) == cfg.num_layers
    for kind, got, ref in zip(tt.layer_kinds(cfg), tp["layers"], want):
        assert ("moe" in got) == (kind == "moe") and set(got) == set(ref)
        flat_got = jax.tree.leaves(jax.tree.map(
            lambda t: t.float().numpy(), got))
        flat_ref = jax.tree.leaves(ref)
        for a, b in zip(flat_got, flat_ref):
            np.testing.assert_array_equal(a, b.astype(np.float32))
    for layer in tp["layers"]:
        if "moe" in layer:
            assert layer["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["w_gate"].dtype == torch.bfloat16
    cast = convert.params_from_numpy(tree, cfg, "cpu", dtype=torch.float16)
    moe = [p["moe"] for p in cast["layers"] if "moe" in p][0]
    assert moe["router"].dtype == torch.float32
    assert moe["w_up"].dtype == torch.float16


@pytest.mark.parametrize("name", NAMES)
def test_ring_prefill_and_decode_match_jax(models, name):
    """The window is 64 for mixtral and h2o-danube: an 80-token prompt
    runs ``windowed_attention`` and leaves a wrapped 64-row ring, on
    which each decode step attends to its last 64 positions."""
    cfg, jp, tp = models(name)
    toks = _prompts(cfg, 2, S)
    max_len = S + 6 + 8
    jc, jlog = jm.prefill(jp, cfg, {"tokens": _j(toks)}, max_len)
    tc, tlog = tm.prefill(tp, cfg, _t(toks), max_len)
    cap = tc["slot_pos"].shape[0]
    assert cap == (64 if cfg.window else max_len) == jc["slot_pos"].shape[0]
    _close(tlog, jlog, atol=1e-4)
    tok = np.asarray(jlog.argmax(-1)).astype(np.int32)[:, None]
    for _ in range(5):
        jn, jlog, jc = jm.decode_step(jp, cfg, jc, _j(tok))
        tn, tlog = tm.decode_step(tp, cfg, tc, _t(tok))
        _close(tlog, jlog, atol=1e-4)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tok = np.asarray(jn)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 5
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    es.assert_kv(tc["layers"], jc, cfg)


@pytest.mark.parametrize("name", NAMES)
def test_generate_greedy_tokens_match_jax(models, name):
    cfg, jp, tp = models(name)
    toks = _prompts(cfg, 3, S, seed=2)
    want, wlen = jgen.generate(jp, cfg, {"tokens": _j(toks)},
                               max_new_tokens=8, eos_id=-1,
                               max_lens=[8, 3, 5])
    got, glen = tgen.generate(tp, cfg, _t(toks), max_new_tokens=8,
                              eos_id=-1, max_lens=[8, 3, 5])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))


C, BS, NB = 3, 4, 6                 # the paged cases' slots, block, table


@pytest.fixture(scope="module")
def kimi_paged_jax(models):
    """The JAX paged path once for both ``use_kernels`` cases: the two
    fused prefill iterations' inputs and logits, the pages after them,
    the 4-step window's tokens and the pages after it."""
    cfg, jp, _ = models("kimi-k2-1t-a32b")
    N = C * NB + 1
    prompts = _prompts(cfg, C, 16, seed=0)
    tables = np.arange(C * NB, dtype=np.int32).reshape(C, NB)
    jc = jt.init_paged_cache(cfg, C, N, BS)
    iters = []
    for ctxs, lens in (([0, 0, 0], [5, 8, 0]), ([5, 8, 0], [11, 8, 16])):
        arrays, Tp = _packed(cfg, prompts, ctxs, lens, tables, N - 1)
        toks, tch, meta, tabs = arrays
        jc, jlog = jm.prefill_chunks(
            jp, cfg, jc, {"tokens": _j(toks)}, _j(tch), _j(meta), _j(tabs),
            chunk_pad=Tp)
        iters.append((arrays, Tp, np.asarray(jlog)))
    first = iters[-1][2].argmax(-1).astype(np.int32)[:C, None]
    jtoks, jc2 = jm.decode_steps_paged(jp, cfg, jc, _j(first), _j(tables),
                                       num_steps=4)
    return dict(tables=tables, iters=iters, prefilled=jc, first=first,
                toks=np.asarray(jtoks), decoded=jc2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_kimi_prefill_chunks_and_paged_decode_window_match_jax(
        models, kimi_paged_jax, use_kernels):
    """``test_torch_model.py::test_prefill_chunks_and_decode_window_match_jax``
    on kimi-k2's stack: the fused prefill routes the whole padded packed
    stream through the MoE layers, as the reference does."""
    cfg, _, tp = models("kimi-k2-1t-a32b")
    want = kimi_paged_jax
    tc = tt.init_paged_cache(cfg, C, C * NB + 1, BS, device="cpu")
    # float32 model, O(1) logits; a flipped bf16 page entry moves them by
    # up to ~1e-3, and the kernels' plain versions keep P in float32
    atol = 2e-3 if not use_kernels else 2e-2
    for (toks, tch, meta, tabs), Tp, jlog in want["iters"]:
        tlog = tm.prefill_chunks(tp, cfg, tc, _t(toks), _t(tch), _t(meta),
                                 _t(tabs), chunk_pad=Tp,
                                 use_kernels=use_kernels)
        _close(tlog, jlog, atol=atol)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                      jlog.argmax(-1))
    es.assert_kv(tc["layers"], want["prefilled"], cfg)
    ttoks = tm.decode_steps_paged(tp, cfg, tc, _t(want["first"]),
                                  _t(want["tables"]), num_steps=4,
                                  use_kernels=use_kernels)
    np.testing.assert_array_equal(ttoks.numpy(), want["toks"])
    es.assert_kv(tc["layers"], want["decoded"], cfg)
    np.testing.assert_array_equal(tc["pos"].numpy(),
                                  np.asarray(want["decoded"]["pos"]))


def test_stack_aux_is_summed_over_the_moe_layers(models):
    """``apply_stack`` returns the MoE layers' aux summed, as the
    reference's; a dense stack's is 0."""
    cfg, jp, tp = models("mixtral-8x22b")
    toks = _prompts(cfg, 2, 24, seed=3)
    x = tm.layers.embed(tp["embed"], _t(toks), cfg)
    _, aux = tt.apply_stack(tp["layers"], x,
                            {"positions": torch.arange(24)}, cfg, None,
                            "prefill")
    jx = jm.layers.embed(jp["embed"], _j(toks), cfg)
    _, _, jaux = jt.apply_stack(jp["stack"], jx,
                                {"positions": jnp.arange(24)}, cfg, None,
                                "train")
    # float32 sums; the reference's drop fraction of an undropped layer
    # may come out a float32 ulp below 0 (its 1 - kept / (T k))
    for k in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-6)
    dense, _, tdense = models("h2o-danube-3-4b")
    _, daux = tt.apply_stack(
        tdense["layers"], tm.layers.embed(tdense["embed"], _t(toks), dense),
        {"positions": torch.arange(24)}, dense, None, "prefill")
    assert daux == {"moe_aux_loss": 0.0, "moe_drop_frac": 0.0}


def test_window_config_refuses_the_paged_cache():
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    assert tt.paged_supported(cfg) == jt.paged_supported(cfg)
    with pytest.raises(NotImplementedError) as got:
        tt.init_paged_cache(cfg, 2, 9, 4, device="cpu")
    with pytest.raises(NotImplementedError) as want:
        jt.init_paged_cache(cfg, 2, 9, 4)
    assert str(got.value) == str(want.value)


def test_kv_cache_capacity_is_the_references():
    for name in NAMES + ["starcoder2-3b"]:
        cfg = configs.get_smoke_config(name)
        for max_len in (16, 64, 200):
            assert tt.kv_cache_capacity(max_len, cfg.window) == \
                jt.kv_cache_capacity(cfg, max_len, cfg.window)
