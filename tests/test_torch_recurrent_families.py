"""PyTorch port: the recurrent model families against
``repro.models.model``, on float32 smoke configs — mamba2-1.3b (``ssm``:
Mamba-2 mixers, no MLP) and recurrentgemma-9b (``hybrid``: rec, rec,
attn_local with a 64-token local window and MQA), whole (3 layers, one
superblock) and cut to 5 layers (one superblock plus the (rec, rec) tail):

  * weight bridge — ``params_from_numpy`` lays the reference's ``scan{s}``
    groups and ``tail{i}`` out in ``layer_kinds`` order, every leaf bit
    for bit, and keeps the reference's float32 leaves (``A_log``,
    ``dt_bias``, ``D``, ``b_a``, ``b_i``, ``Lambda``) float32 under a
    cast; ``model.init_params`` makes the reference's tree, dtypes
    included;
  * the contiguous cache — ``prefill`` of 80-token prompts (past the
    hybrid's window, so its rings wrap) and ``decode_step``: logits within
    1e-3, greedy tokens, ``pos`` and ``slot_pos`` identical, every state
    leaf within ``assert_kv``'s rule (``generate``, batch mode's loop, is
    held to the JAX engine's in tests/test_torch_recurrent_engine.py);
  * scope — every published config builds on the ``meta`` device, and
    the paged modes refuse recurrent layers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_engine_setup as es  # noqa: E402
from test_torch_model import _close  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

#: model name -> layers (None: the smoke config's own)
MODELS = {"mamba2-1.3b": None, "recurrentgemma-9b": None,
          "recurrentgemma-9b-5": 5}
S = 80                      # prompt length, past the hybrid's window of 64


def _cfg(name, dtype="float32"):
    base = configs.get_smoke_config(name.rsplit("-5", 1)[0]
                                    if name.endswith("-5") else name)
    cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype)
    layers = MODELS.get(name)
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(name):
        if name not in memo:
            cfg = _cfg(name)
            jp = jm.init_params(jax.random.PRNGKey(0), cfg)
            tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                           cfg, "cpu")
            memo[name] = (cfg, jp, tp)
        return memo[name]

    return get


def _prompts(cfg, B, n, seed=1):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, n)).astype(np.int32)


def test_stack_pattern_is_the_references():
    for name in MODELS:
        cfg = _cfg(name)
        assert tt.stack_pattern(cfg) == jt.stack_pattern(cfg)
    assert tt.layer_kinds(_cfg("recurrentgemma-9b-5")) == (
        "rec", "rec", "attn_local", "rec", "rec")
    assert tt.layer_kinds(configs.get_config("recurrentgemma-9b")) == (
        ("rec", "rec", "attn_local") * 12 + ("rec", "rec"))


@pytest.mark.parametrize("name", list(MODELS))
def test_params_from_numpy_follows_the_stack_pattern(models, name):
    cfg, jp, tp = models(name)
    tree = jax.tree.map(np.asarray, jp)
    pat, n, _, tail = jt.stack_pattern(cfg)
    want = ([jax.tree.map(lambda a, r=r: a[r], tree["stack"][f"scan{s}"])
             for r in range(n) for s in range(len(pat))]
            + [tree["stack"][f"tail{i}"] for i in range(len(tail))])
    assert len(tp["layers"]) == len(want) == cfg.num_layers
    for got, ref in zip(tp["layers"], want):
        assert jax.tree.structure(jax.tree.map(lambda t: 0, got)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, ref))
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got)),
                        jax.tree.leaves(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    cast = convert.params_from_numpy(tree, cfg, "cpu", dtype=torch.bfloat16)
    for layer in cast["layers"]:
        for block in (layer.get("mixer"), layer.get("rec")):
            for k, v in (block or {}).items():
                want_dt = (torch.float32 if k in convert.FLOAT32_LEAVES
                           else torch.bfloat16)
                assert v.dtype == want_dt, (k, v.dtype)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b-5"])
def test_init_params_makes_the_references_tree(name):
    """Same layout, shapes and dtypes as the reference's ``init_params``
    (bf16 parameters, the float32 leaves kept)."""
    cfg = _cfg(name, "bfloat16")
    jtree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    tp = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for got, ref in zip(tp["layers"], convert.stack_layers(jtree["stack"],
                                                           cfg)):
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got)
        ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref)
        assert got == ref


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_and_decode_match_jax(models, name):
    cfg, jp, tp = models(name)
    toks = _prompts(cfg, 2, S)
    max_len = S + 6 + 8
    jc, jlog = jm.prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, max_len)
    tc, tlog = tm.prefill(tp, cfg, _t(toks), max_len)
    cap = 1 if cfg.family == "ssm" else cfg.local_window
    assert tc["slot_pos"].shape[0] == cap == jc["slot_pos"].shape[0]
    _close(tlog, jlog, atol=1e-3)
    es.assert_kv(tc["layers"], jc, cfg)
    tok = np.asarray(jlog.argmax(-1)).astype(np.int32)[:, None]
    for _ in range(5):
        jn, jlog, jc = jm.decode_step(jp, cfg, jc, jnp.asarray(tok))
        tn, tlog = tm.decode_step(tp, cfg, tc, _t(tok))
        _close(tlog, jlog, atol=1e-3)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tok = np.asarray(jn)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 5
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    es.assert_kv(tc["layers"], jc, cfg)


@pytest.mark.parametrize("name", list(tconfigs.ARCH_IDS))
def test_every_published_config_builds_on_meta(name):
    """Every family is ported: each published config builds its
    parameters (encoder and projector included) and its contiguous cache
    at full width on the ``meta`` device, one entry a layer in
    ``layer_kinds`` order, each with the reference's cache leaves."""
    cfg = tconfigs.get_config(name)
    params = tm.init_params(cfg, torch.Generator(), "meta")
    kinds = tt.layer_kinds(cfg)
    assert len(params["layers"]) == len(kinds) == cfg.num_layers
    assert ("encoder" in params) == (cfg.family == "encdec")
    assert ("frontend_proj" in params) == bool(cfg.frontend)
    cache = tt.init_cache(cfg, 1, 64, device="meta")
    assert len(cache["layers"]) == cfg.num_layers
    for kind, lc in zip(kinds, cache["layers"]):
        want = {"ssm": {"conv", "ssd"}, "rec": {"conv", "h"},
                "cross": {"k", "v", "enc_k", "enc_v"}}.get(kind, {"k", "v"})
        assert set(lc) == want, (kind, set(lc))
    if cfg.family == "encdec":
        assert cache["layers"][0]["enc_k"].shape == (
            1, cfg.encoder_seq_len, cfg.num_kv_heads, cfg.head_dim)
        assert len(params["encoder"]["blocks"]) == cfg.num_encoder_layers


@pytest.mark.parametrize("mode", ["decode_paged", "chunk", "chunks"])
def test_paged_modes_refuse_recurrent_layers(models, mode):
    """As the reference's ``apply_block_chunk`` / ``apply_block_chunks``:
    only dense and MoE layers take the paged modes."""
    cfg, _, tp = models("recurrentgemma-9b")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError,
                       match="requires a paged-eligible stack"):
        tt.apply_stack(tp["layers"], x, {}, cfg, {"layers": [{}] * 3}, mode)
