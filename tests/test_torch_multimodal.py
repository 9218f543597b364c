"""PyTorch port: the vlm (llava-next-mistral-7b) and encoder-decoder
(seamless-m4t-large-v2) families at model level against
``repro.models``, on float32 smoke configs, B 2 and S 24 as the
reference's smoke tests:

  * the frontend stubs — ``multimodal.apply_projector`` against the
    reference's on the same weights (float32 within 1e-5 of the scale,
    bf16 stubs promoted as JAX promotes them), the stub embeddings' shapes
    and dtypes, and ``add_modality_stub``'s patches and frames bit for
    bit;
  * the weight bridge — ``params_from_numpy`` carries the encoder (the
    vmapped ``blocks`` as a list), ``frontend_proj`` and the ``cross``
    leaves bit for bit; ``init_params`` makes the reference's tree;
  * llava — ``prefill`` with patches, then 5 ``decode_step`` calls: logits
    within 1e-4, greedy tokens, ``pos`` (P + S + 5) and ``slot_pos``
    identical;
  * seamless — ``encode`` within 1e-5 of the scale; ``prefill`` with frames
    and 5 decode steps as above; the cached ``enc_k`` / ``enc_v`` of a
    float32 cache within 1e-5 of the reference's;
  * ``generate`` with patches or frames: tokens and lengths identical to
    the reference's ``generate``;
  * decode against the training forward (``apply_stack(mode="train")``,
    the reference's ``test_decode_matches_forward``): the decode logits
    at each position within 1e-4 of one forward over the whole
    sequence.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_engine_setup as es  # noqa: E402
from test_torch_train_step import one_thread  # noqa: E402,F401

from repro import configs  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import multimodal as jmm  # noqa: E402
from repro.serving import generate as jgen  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import multimodal as tmm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import generate as tgen  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402

NAMES = ["llava-next-mistral-7b", "seamless-m4t-large-v2"]
B, S = 2, 24
#: float32 tolerances (summation order of the float32 products): logits
#: absolute; the encoder memory relative to the reference's largest |value|
LOGIT_ATOL = 1e-4
RTOL = 1e-5


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close_scaled(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=0)


def _close_logits(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL, rtol=0)


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


@pytest.fixture(scope="module")
def models():
    memo = {}

    def get(name):
        if name not in memo:
            m = es.models(name)
            memo[name] = (m["cfg"], m["jp"], m["tp"])
        return memo[name]

    return get


def _batches(cfg, n=S, seed=0):
    toks = np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (B, n)).astype(np.int32)
    jb = jdata.add_modality_stub({"tokens": jnp.asarray(toks)}, cfg)
    tb = tdata.add_modality_stub({"tokens": torch.from_numpy(toks)}, cfg)
    return jb, tb, {k: v for k, v in tb.items() if k != "tokens"}


# ---------------------------------------------------------------------------
# frontend stubs and the weight bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stub_dtype", ["float32", "bfloat16"])
def test_projector_matches_reference(stub_dtype):
    cfg = es.cfg32("llava-next-mistral-7b")
    jp = jmm.init_projector(jax.random.PRNGKey(3), cfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    # non-zero biases, so the test sees them added
    for i, k in enumerate(("b1", "b2")):
        b = np.random.default_rng(i).standard_normal(cfg.d_model) * 0.1
        jp[k] = jnp.asarray(b, jnp.float32)
        tp[k] = torch.from_numpy(b.astype(np.float32))
    emb = np.random.default_rng(7).standard_normal((B, 5, cfg.d_model))
    jemb = jnp.asarray(emb, getattr(jnp, stub_dtype))
    temb = torch.from_numpy(emb).to(getattr(torch, stub_dtype))
    want = jmm.apply_projector(jp, jemb)
    got = tmm.apply_projector(tp, temb)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close_scaled(got, want)


def test_stub_embeddings_and_modality_stubs():
    for name in NAMES:
        cfg = configs.get_smoke_config(name)
        gen = torch.Generator().manual_seed(0)
        p = tmm.stub_patch_embeddings(gen, B, cfg)
        f = tmm.stub_frame_embeddings(gen, B, cfg, dtype=torch.float32)
        assert p.shape == (B, cfg.num_patch_tokens, cfg.d_model)
        assert p.dtype == torch.bfloat16
        assert f.shape == (B, cfg.encoder_seq_len, cfg.d_model)
        assert f.dtype == torch.float32
        jb, tb, kw = _batches(cfg)
        key = "patches" if cfg.frontend == "vision" else "frames"
        assert set(kw) == {key}
        assert kw[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(kw[key]), np.asarray(jb[key]).view(np.int16))


@pytest.mark.parametrize("name", NAMES)
def test_params_from_numpy_carries_encoder_projector_and_cross(name):
    cfg = configs.get_smoke_config(name)
    jp = jm.init_params(jax.random.PRNGKey(1), cfg)
    tree = jax.tree.map(np.asarray, jp)
    tp = convert.params_from_numpy(tree, cfg, "cpu")
    for k, v in tree["frontend_proj"].items():
        np.testing.assert_array_equal(_bits(tp["frontend_proj"][k]),
                                      v.view(np.int16))
    if cfg.family == "encdec":
        assert tt.layer_kinds(cfg) == ("cross",) * cfg.num_layers
        blocks = tp["encoder"]["blocks"]
        assert len(blocks) == cfg.num_encoder_layers
        for i, blk in enumerate(blocks):
            np.testing.assert_array_equal(
                _bits(blk["attn"]["wq"]),
                tree["encoder"]["blocks"]["attn"]["wq"][i].view(np.int16))
        for i, layer in enumerate(tp["layers"]):
            for k in ("wq", "wk", "wv", "wo"):
                np.testing.assert_array_equal(
                    _bits(layer["xattn"][k]),
                    tree["stack"]["scan0"]["xattn"][k][i].view(np.int16))
            np.testing.assert_array_equal(
                _bits(layer["ln_x"]),
                tree["stack"]["scan0"]["ln_x"][i].view(np.int16))
    else:
        assert "encoder" not in tp
        assert tt.layer_kinds(cfg) == ("dense",) * cfg.num_layers
    # the port's own init builds the same tree, dtypes included
    mine = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), str(t.dtype))

    assert shapes(mine) == shapes(tp)


# ---------------------------------------------------------------------------
# prefill, decode, encode, generate
# ---------------------------------------------------------------------------


def _decode(cfg, jp, tp, jc, tc, jlog, steps=5):
    tok = np.asarray(jlog.argmax(-1)).astype(np.int32)[:, None]
    for _ in range(steps):
        jn, jlog, jc = jm.decode_step(jp, cfg, jc, jnp.asarray(tok))
        tn, tlog = tm.decode_step(tp, cfg, tc, torch.from_numpy(tok))
        _close_logits(tlog, jlog)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tok = np.asarray(jn).copy()
    return jc


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode(models, name):
    cfg, jp, tp = models(name)
    jb, tb, kw = _batches(cfg)
    P = cfg.num_patch_tokens if cfg.frontend == "vision" else 0
    max_len = P + S + 8
    jc, jlog = jm.prefill(jp, cfg, jb, max_len)
    tc, tlog = tm.prefill(tp, cfg, tb["tokens"], max_len, **kw)
    assert tlog.shape == (B, cfg.padded_vocab)
    _close_logits(tlog, jlog)
    jc = _decode(cfg, jp, tp, jc, tc, jlog)
    assert int(tc["pos"]) == int(jc["pos"]) == P + S + 5
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    es.assert_kv([{k: v for k, v in lc.items() if k in ("k", "v")}
                  for lc in tc["layers"]], jc, cfg)


def test_vision_needs_patches_and_encdec_frames(models):
    for name, key in zip(NAMES, ("patches", "frames")):
        cfg, _, tp = models(name)
        with pytest.raises(ValueError, match=key):
            tm.prefill(tp, cfg, torch.zeros((1, 4), dtype=torch.int32), 16)


def test_seamless_encode_and_cached_encoder_kv(models):
    cfg, jp, tp = models("seamless-m4t-large-v2")
    jb, tb, kw = _batches(cfg)
    with torch.no_grad():
        got = tm.encode(tp, cfg, kw["frames"])
    want = jm.encode(jp, cfg, jb["frames"])
    assert got.shape == (B, cfg.encoder_seq_len, cfg.d_model)
    _close_scaled(got, want)
    # a float32 cache keeps the projections unrounded
    jc, jlog = jm.prefill(jp, cfg, jb, S + 8, cache_dtype=jnp.float32)
    tc, tlog = tm.prefill(tp, cfg, tb["tokens"], S + 8,
                          cache_dtype=torch.float32, **kw)
    _close_logits(tlog, jlog)
    jlayers = convert.stack_layers(jc, cfg)
    for lc, jl_ in zip(tc["layers"], jlayers):
        for k in ("enc_k", "enc_v"):
            assert lc[k].shape == (B, cfg.encoder_seq_len, cfg.num_kv_heads,
                                   cfg.head_dim)
            np.testing.assert_allclose(lc[k].numpy(), np.asarray(jl_[k]),
                                       atol=1e-5, rtol=0)
    _decode(cfg, jp, tp, jc, tc, jlog)


@pytest.mark.parametrize("name", NAMES)
def test_generate_with_patches_or_frames(models, name):
    cfg, jp, tp = models(name)
    jb, tb, kw = _batches(cfg, seed=4)
    jt, jl = jgen.generate(jp, cfg, jb, max_new_tokens=6, eos_id=-1)
    tt_, tl_ = tgen.generate(tp, cfg, tb["tokens"], max_new_tokens=6,
                             eos_id=-1, **kw)
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl_.numpy(), np.asarray(jl))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_training_forward(models, name):
    """The reference's tests/test_generate.py property on the port: the
    decode logits at positions S-1 .. S+T-1 equal one training-mode
    forward over the whole sequence (text positions only); float32
    caches, so the decode reads the K/V the forward computed."""
    cfg, _, tp = models(name)
    T, S0 = 5, 12
    _, tb, kw = _batches(cfg, n=S0 + T, seed=5)
    tokens = tb["tokens"]
    P = cfg.num_patch_tokens if cfg.frontend == "vision" else 0
    cache, last = tm.prefill(tp, cfg, tokens[:, :S0], P + S0 + T + 1,
                             cache_dtype=torch.float32, **kw)
    dec = [last]
    for t in range(T):
        _, lg = tm.decode_step(tp, cfg, cache, tokens[:, S0 + t:S0 + t + 1])
        dec.append(lg)
    with torch.no_grad():
        x, ctx, n_prefix = tm._decoder_inputs(tp, cfg, tokens,
                                              kw.get("patches"),
                                              kw.get("frames"))
        x, _ = tt.apply_stack(tp["layers"], x, ctx, cfg, None, "train")
        x = tl.rms_norm(x, tp["final_ln"], cfg.norm_eps)[:, n_prefix:]
        full = tl.logits(tp["embed"], x, cfg).float()
    V = cfg.vocab_size
    _close_logits(torch.stack(dec, dim=1)[..., :V],
                  full[:, S0 - 1:S0 + T, :V])

