"""PyTorch port: layers, paged primitives and the model against JAX.

  * layers — each dense layer against ``repro.models.layers`` in float32,
    the tanh GELU included;
  * paged primitives — ``gather_tokens`` and the three scatters give
    bit-equal pages, including the table-width clamp, the trash page and
    the drop of invalid packed rows;
  * weight bridge — ``params_from_numpy`` is an exact copy (bf16 and f32);
  * model — two fused ragged prefill iterations plus a paged decode
    window against ``repro.models.model`` on the float32 starcoder2-3b
    smoke config: logits within a stated tolerance, greedy tokens
    identical, pages equal (see ``_assert_pages`` for the one stated
    exception); the bulk lane's ring-cache prefill/decode likewise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.prefill import build_packed_arrays  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

# float32 layers: XLA and PyTorch sum in other orders, O(1) values
ATOL = 2e-5


def _f32(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_and_rope():
    x, w = _f32(2, 5, 4, 32), _f32(32, seed=1) * 0.1
    _close(tl.rms_norm(_t(x), _t(w)), jl.rms_norm(_j(x), _j(w)))
    pos = np.arange(5, dtype=np.int32) + 7
    _close(tl.apply_rope(_t(x), _t(pos), 1e4),
           jl.apply_rope(_j(x), _j(pos), 1e4))


@pytest.mark.parametrize("act", ["gelu", "swiglu", "relu"])
def test_mlp(act):
    x = _f32(2, 3, 16)
    p = {"w_up": _f32(16, 48, seed=1) * 0.2,
         "w_down": _f32(48, 16, seed=2) * 0.2,
         "w_gate": _f32(16, 48, seed=3) * 0.2}
    want = jl.apply_mlp({k: _j(v) for k, v in p.items()}, _j(x), act)
    _close(tl.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act), want)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(torch.nn.functional.gelu(_t(x), approximate="tanh"),
           jax.nn.gelu(_j(x)), atol=1e-6)


def test_attention_projections_embed_logits():
    cfg = dataclasses.replace(configs.get_smoke_config("starcoder2-3b"),
                              vocab_size=2000)       # padded vocab masks
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _f32(D, H, hd, seed=1) * 0.05,
         "wk": _f32(D, KV, hd, seed=2) * 0.05,
         "wv": _f32(D, KV, hd, seed=3) * 0.05,
         "wo": _f32(H, hd, D, seed=4) * 0.05}
    x = _f32(2, 6, D)
    pos = np.arange(6, dtype=np.int32) + 3
    want = jl.attention_qkv({k: _j(v) for k, v in p.items()}, _j(x),
                            _j(pos), cfg.rope_theta)
    got = tl.attention_qkv({k: _t(v) for k, v in p.items()}, _t(x),
                           _t(pos), cfg.rope_theta)
    for a, b in zip(got, want):
        _close(a, b)
    a = _f32(2, 6, H, hd, seed=5)
    _close(tl.attention_out({"wo": _t(p["wo"])}, _t(a)),
           jl.attention_out({"wo": _j(p["wo"])}, _j(a)), atol=1e-4)
    emb = {"embedding": _f32(cfg.padded_vocab, D, seed=6) * 0.05}
    toks = np.asarray([[3, 1999, 0]], np.int32)
    _close(tl.embed({"embedding": _t(emb["embedding"])}, _t(toks), cfg),
           jl.embed({"embedding": _j(emb["embedding"])}, _j(toks), cfg))
    h = _f32(1, 3, D, seed=7)
    got = tl.logits({"embedding": _t(emb["embedding"])}, _t(h), cfg)
    want = jl.logits({"embedding": _j(emb["embedding"])}, _j(h), cfg)
    assert cfg.padded_vocab > cfg.vocab_size
    _close(got, want, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_and_decode_attention(dtype):
    q = _f32(2, 9, 8, 32)
    k, v = _f32(2, 20, 2, 32, seed=1), _f32(2, 20, 2, 32, seed=2)
    qp = np.arange(9, dtype=np.int32) + 11
    kp = np.arange(20, dtype=np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.chunked_attention(_j(q).astype(jd), _j(k).astype(jd),
                                _j(v).astype(jd), q_positions=_j(qp),
                                kv_positions=_j(kp), causal=True, kv_chunk=8)
    got = tl.chunked_attention(_t(q).to(td), _t(k).to(td), _t(v).to(td),
                               q_positions=_t(qp), kv_positions=_t(kp),
                               causal=True, kv_chunk=8)
    # bf16: the probabilities are cast to the value dtype before P.V in
    # both, so the outputs agree to a bf16 ulp
    _close(got, want.astype(jnp.float32),
           atol=ATOL if dtype == "float32" else 1.6e-2)
    # per-slot decode (the paged plain path's form)
    qd = _f32(2, 1, 8, 32, seed=3)
    qpos = np.asarray([13, 4], np.int32)
    kvpos = np.broadcast_to(kp, (2, 20)).copy()
    want = jl.decode_attention(_j(qd).astype(jd), _j(k).astype(jd),
                               _j(v).astype(jd), q_position=_j(qpos),
                               kv_positions=_j(kvpos), valid_len=_j(qpos + 1))
    got = tl.decode_attention(_t(qd).to(td), _t(k).to(td), _t(v).to(td),
                              q_position=_t(qpos), kv_positions=_t(kvpos),
                              valid_len=_t(qpos + 1))
    _close(got, want.astype(jnp.float32),
           atol=ATOL if dtype == "float32" else 1.6e-2)


# ---------------------------------------------------------------------------
# paged primitives (bit-equal pages)
# ---------------------------------------------------------------------------


def _pages(N=7, bs=4, seed=0):
    a = _f32(N, bs, 2, 8, seed=seed)
    return jnp.asarray(a).astype(jnp.bfloat16), \
        torch.from_numpy(a).to(torch.bfloat16)


def _bits_equal(t, j):
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy(),
        np.asarray(j).view(np.int16))


def test_gather_and_scatter_token_with_clamp():
    pj, pt = _pages()
    tables = np.asarray([[2, 5], [6, 6], [0, 1]], np.int32)
    # row 1 is a dead row on the trash page (6) with a stale position far
    # past its table: the clamp keeps the write on the trash page
    pos = np.asarray([5, 40, 2], np.int32)
    vals = _f32(3, 2, 8, seed=9)
    want = jpaged.scatter_token(pj, _j(vals), _j(tables), _j(pos))
    tpaged.scatter_token(pt, _t(vals), _t(tables), _t(pos))
    _bits_equal(pt, want)
    _bits_equal(tpaged.gather_tokens(pt, _t(tables)),
                jpaged.gather_tokens(want, _j(tables)))


def test_scatter_chunk_clamps_to_table():
    pj, pt = _pages(seed=1)
    row = np.asarray([3, 4], np.int32)
    seq = _f32(6, 2, 8, seed=2)
    for start in (0, 5):                     # 5..10 runs past the table
        pj = jpaged.scatter_chunk(pj, _j(seq), _j(row), jnp.int32(start))
        tpaged.scatter_chunk(pt, _t(seq), _t(row), start)
        _bits_equal(pt, pj)


def test_scatter_packed_drops_invalid_rows():
    pj, pt = _pages(seed=3)
    tables = np.asarray([[1, 2], [4, 5]], np.int32)
    token_chunk = np.asarray([0, 0, 0, 1, 1, 1, 1, 1], np.int32)
    positions = np.asarray([3, 4, 5, 0, 1, 2, 9, 30], np.int32)
    valid = np.asarray([1, 1, 1, 1, 1, 1, 0, 0], bool)
    seq = _f32(8, 2, 8, seed=4)
    want = jpaged.scatter_packed(pj, _j(seq), _j(tables), _j(token_chunk),
                                 _j(positions), _j(valid))
    tpaged.scatter_packed(pt, _t(seq), _t(tables), _t(token_chunk),
                          _t(positions), _t(valid))
    _bits_equal(pt, want)
    # the dropped rows touched nothing: pages 0, 3 and 6 are unchanged
    _, p0 = _pages(seed=3)
    for page in (0, 3, 6):
        assert torch.equal(pt[page], p0[page])


def test_paged_cache_container():
    cfg = configs.get_smoke_config("starcoder2-3b")
    kvc = tpaged.PagedKVCache(cfg, num_slots=3, num_blocks=10,
                              block_size=4, max_len=14, device="cpu")
    jkvc = jpaged.PagedKVCache(cfg, num_slots=3, num_blocks=10,
                               block_size=4, max_len=14)
    for c in (kvc, jkvc):
        c.set_table(1, [4, 2])
        c.extend_table(1, 2, 7)
        c.clear_table(0)
    np.testing.assert_array_equal(kvc.tables, jkvc.tables)
    assert kvc.trash_block == 10 and kvc.max_blocks_per_seq == 4
    assert len(kvc.state["layers"]) == cfg.num_layers
    assert tuple(kvc.state["layers"][0]["k"].shape) == (11, 4, 2, 32)
    assert kvc.tables_device().dtype == torch.int32


@pytest.mark.parametrize("make", [
    lambda cfg: tpaged.PagedKVCache(cfg, num_slots=3, num_blocks=10,
                                    block_size=4, max_len=14),
    lambda cfg: tt.init_paged_cache(cfg, 3, 11, 4),
    lambda cfg: tt.init_cache(cfg, 2, 14),
], ids=["PagedKVCache", "init_paged_cache", "init_cache"])
def test_cache_constructors_need_a_card_unless_cpu_is_asked_for(
        make, monkeypatch):
    """``device=None`` means the card: with none present the constructor
    raises instead of building its state on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(configs.get_smoke_config("starcoder2-3b"))


# ---------------------------------------------------------------------------
# weight bridge and model
# ---------------------------------------------------------------------------


def _cfg32():
    return dataclasses.replace(configs.get_smoke_config("starcoder2-3b"),
                               param_dtype="float32",
                               compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    cfg = _cfg32()
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_exact(dtype):
    cfg = dataclasses.replace(configs.get_smoke_config("starcoder2-3b"),
                              param_dtype=dtype)
    jp = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1), cfg))
    tp = convert.params_from_numpy(jp, cfg, "cpu")
    assert len(tp["layers"]) == cfg.num_layers
    for i in range(cfg.num_layers):
        for blk, k in (("attn", "wq"), ("attn", "wo"), ("mlp", "w_up")):
            got = tp["layers"][i][blk][k]
            assert got.dtype == getattr(torch, dtype)
            want = jp["stack"]["scan0"][blk][k][i]
            assert tuple(got.shape) == want.shape
            np.testing.assert_array_equal(got.float().numpy(),
                                          want.astype(np.float32))
    np.testing.assert_array_equal(
        tp["embed"]["embedding"].float().numpy(),
        jp["embed"]["embedding"].astype(np.float32))


def _assert_pages(tc, jc, cfg):
    """Pages hold bf16 K/V that each framework computes in float32.  XLA
    and PyTorch sum the projections in other (and, threaded, not always
    the same) orders, so a value within a float32 ulp of a bf16 rounding
    boundary can round the other way; a flipped K/V entry then shifts the
    later layers' inputs by ~1e-3 and flips a few more there (ROADMAP
    Queue 3; up to 2.3 % of a pool's entries over repeated runs of this
    test, so the bound below is 10 %).  So the model-level pages agree
    to two bf16 ulps (2^-6 relative) and nearly all entries are
    bit-equal; bit-equality on identical inputs is pinned by the
    primitive and kernel tests."""
    for i in range(cfg.num_layers):
        for kv in ("k", "v"):
            a = tc["layers"][i][kv]
            b = np.asarray(jc["scan0"][kv][i])
            diff = a.view(torch.int16).numpy() != b.view(np.int16)
            assert diff.mean() < 0.1, (i, kv, int(diff.sum()))
            np.testing.assert_allclose(a.float().numpy(),
                                       b.astype(np.float32),
                                       rtol=2.0 ** -6, atol=1e-3)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def _packed(cfg, prompts, ctxs, lens, tables, trash):
    entries = [(s, ctxs[s], prompts[s, ctxs[s]:ctxs[s] + lens[s]],
                tables[s]) for s in range(len(lens)) if lens[s]]
    tot, TTp, Tp = sum(lens), 1, 1
    while TTp < tot:
        TTp *= 2
    while Tp < max(lens):
        Tp *= 2
    Cp = 1
    while Cp < len(entries):
        Cp *= 2
    return build_packed_arrays((TTp, Cp, Tp), entries, pad_slot=len(lens),
                               table_width=tables.shape[1],
                               trash_block=trash), Tp


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_chunks_and_decode_window_match_jax(models, use_kernels):
    """``use_kernels=False`` is the reference's jnp path; ``True`` runs the
    kernel wrappers, which on CPU tensors take their plain versions (no
    probability cast to the page dtype before P.V, hence the wider
    logit tolerance)."""
    cfg, jp, tp = models
    C, bs, nb = 3, 4, 6
    N = C * nb + 1
    trash = N - 1
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, (C, 16))
    tables = np.arange(C * nb, dtype=np.int32).reshape(C, nb)
    jc = jt.init_paged_cache(cfg, C, N, bs)
    tc = tt.init_paged_cache(cfg, C, N, bs, device="cpu")
    # float32 model, 2 layers, O(1) logits; a flipped bf16 page entry
    # (see _assert_pages) moves them by up to ~1e-3
    atol = 2e-3 if not use_kernels else 2e-2
    for ctxs, lens in (([0, 0, 0], [5, 8, 0]), ([5, 8, 0], [11, 8, 16])):
        (toks, tch, meta, tabs), Tp = _packed(cfg, prompts, ctxs, lens,
                                              tables, trash)
        jc, jlog = jm.prefill_chunks(
            jp, cfg, jc, {"tokens": _j(toks)}, _j(tch), _j(meta), _j(tabs),
            chunk_pad=Tp)
        tlog = tm.prefill_chunks(tp, cfg, tc, _t(toks), _t(tch), _t(meta),
                                 _t(tabs), chunk_pad=Tp,
                                 use_kernels=use_kernels)
        _close(tlog, jlog, atol=atol)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                      np.asarray(jlog.argmax(-1)))
    _assert_pages(tc, jc, cfg)
    first = np.asarray(jlog.argmax(-1)).astype(np.int32)[:C, None]
    jtoks, jc = jm.decode_steps_paged(jp, cfg, jc, _j(first), _j(tables),
                                      num_steps=4)
    ttoks = tm.decode_steps_paged(tp, cfg, tc, _t(first), _t(tables),
                                  num_steps=4, use_kernels=use_kernels)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _assert_pages(tc, jc, cfg)
    _, jlog = jm.decode_step_paged(jp, cfg, jc, jtoks[:, -1:], _j(tables))[:2]
    _, tlog = tm.decode_step_paged(tp, cfg, tc, ttoks[:, -1:], _t(tables),
                                   use_kernels=use_kernels)
    _close(tlog, jlog, atol=atol)


def test_bulk_lane_prefill_and_decode_match_jax(models):
    cfg, jp, tp = models
    toks = np.random.default_rng(1).integers(2, cfg.vocab_size, (3, 8))
    toks = toks.astype(np.int32)
    jc, jlog = jm.prefill(jp, cfg, {"tokens": _j(toks)}, 20)
    tc, tlog = tm.prefill(tp, cfg, _t(toks), 20)
    _close(tlog, jlog, atol=1e-4)
    tok = np.asarray(jlog.argmax(-1)).astype(np.int32)[:, None]
    for _ in range(3):
        jn, jlog, jc = jm.decode_step(jp, cfg, jc, _j(tok))
        tn, tlog = tm.decode_step(tp, cfg, tc, _t(tok))
        _close(tlog, jlog, atol=1e-4)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        tok = np.asarray(jn)
    assert int(tc["pos"]) == int(jc["pos"]) == 11
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))


def test_non_dense_families_are_refused():
    cfg = configs.get_smoke_config("mixtral-8x22b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tm.init_params(cfg, gen, "cpu")
