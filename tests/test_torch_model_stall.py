"""PyTorch port: the model functions of stall admission and the prefix
cache against JAX, on the float32 starcoder2-3b smoke config.

  * per-slot ring cache — ``prefill_into_slot`` into two slots admitted at
    different steps, then ``decode_steps`` windows with each row at its own
    position, against ``repro.models.model``: logits within a stated
    tolerance, greedy tokens identical, ``pos``/``slot_pos`` equal and the
    ring K/V by the rule of ``torch_engine_setup.assert_kv``; with the
    ring longer than, as long as and shorter than the prompt (the rolled
    layout);
  * ``write_slot`` — bit-equal to the reference's on identical inputs, and
    a recycled slot equals a freshly admitted one while its neighbour stays
    untouched (the reference's tests/test_continuous.py:153);
  * paged — ``prefill_into_paged`` then a paged decode window against JAX;
    ``scatter_prefill``, ``copy_block`` and ``copy_paged_block`` bit-equal
    on identical inputs; ``default_num_blocks`` and
    ``PagedKVCache.table_row`` equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_engine_setup as es  # noqa: E402

from repro.kvcache import paged as jpaged  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.kvcache import paged as tpaged  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

# float32 model, 2 layers, O(1) logits; a bf16 cache entry that rounds the
# other way in one framework (torch_engine_setup.assert_kv) moves them by
# up to ~1e-3
LOGIT_ATOL = 2e-3


@pytest.fixture(scope="module")
def models():
    cfg = es.cfg32()
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def _prompts(cfg, n, S, seed):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size, (n, S)).astype(np.int32)


def _close(t, j, atol=LOGIT_ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol,
                               rtol=atol)


def _bits_equal(t, j):
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  np.asarray(j).view(np.int16))


# ---------------------------------------------------------------------------
# per-slot ring cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [20, 8, 6], ids=["S<W", "S==W", "S>W"])
def test_slot_prefill_and_decode_windows_match_jax(models, max_len):
    cfg, jp, tp = models
    S = 8
    prompts = _prompts(cfg, 2, S, seed=1)
    jc = jt.init_slot_cache(cfg, 2, max_len)
    tc = tt.init_slot_cache(cfg, 2, max_len, device="cpu")
    tok = np.zeros((2, 1), np.int32)
    for slot, steps in ((0, 2), (1, 3)):
        jc, jlog = jm.prefill_into_slot(jp, cfg, jc,
                                        {"tokens": jnp.asarray(
                                            prompts[slot:slot + 1])},
                                        slot, max_len)
        tlog = tm.prefill_into_slot(tp, cfg, tc,
                                    torch.from_numpy(prompts[slot:slot + 1]),
                                    slot, max_len)
        assert tlog.shape == (cfg.padded_vocab,)
        _close(tlog, jlog)
        tok[slot, 0] = int(np.asarray(jlog).argmax())
        assert int(tlog.argmax()) == tok[slot, 0]
        # a window with every row at its own position (row 1 stays empty
        # or trails row 0 by two steps)
        jtoks, jc = jm.decode_steps(jp, cfg, jc, jnp.asarray(tok),
                                    num_steps=steps)
        ttoks = tm.decode_steps(tp, cfg, tc, torch.from_numpy(tok),
                                num_steps=steps)
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        tok = np.asarray(jtoks)[:, -1:].copy()
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        es.assert_kv(tc["layers"], jc, cfg)
    assert tc["pos"].tolist() == [S + 5, S + 3]
    _, jlog, _ = jm.decode_step(jp, cfg, jc, jnp.asarray(tok))
    _, tlog = tm.decode_step(tp, cfg, tc, torch.from_numpy(tok))
    _close(tlog, jlog)


def _ring(cfg, B, W, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, B, W, cfg.num_kv_heads, cfg.head_dim)
    return (rng.standard_normal(shape, np.float32),
            rng.standard_normal(shape, np.float32),
            rng.integers(0, 50, (B,)).astype(np.int32),
            rng.integers(0, 50, (B, W)).astype(np.int32))


def test_write_slot_matches_jax_bit_for_bit(models):
    cfg = models[0]
    W = 12
    k, v, pos, slot_pos = _ring(cfg, 3, W, seed=2)
    ok, ov, _, _ = _ring(cfg, 1, W, seed=3)
    one_pos, one_sp = np.int32(9), np.arange(W, dtype=np.int32) * 3
    jcache = {"scan0": {"k": jnp.asarray(k).astype(jnp.bfloat16),
                        "v": jnp.asarray(v).astype(jnp.bfloat16)},
              "pos": jnp.asarray(pos), "slot_pos": jnp.asarray(slot_pos)}
    jone = {"scan0": {"k": jnp.asarray(ok), "v": jnp.asarray(ov)},
            "pos": jnp.asarray(one_pos), "slot_pos": jnp.asarray(one_sp)}
    want = jt.write_slot(jcache, jone, 1)
    tcache = {"layers": [{"k": torch.from_numpy(k[i]).to(torch.bfloat16),
                          "v": torch.from_numpy(v[i]).to(torch.bfloat16)}
                         for i in range(cfg.num_layers)],
              "pos": torch.from_numpy(pos.copy()),
              "slot_pos": torch.from_numpy(slot_pos.copy())}
    tone = {"layers": [{"k": torch.from_numpy(ok[i]),
                        "v": torch.from_numpy(ov[i])}
                       for i in range(cfg.num_layers)],
            "pos": torch.tensor(one_pos), "slot_pos": torch.from_numpy(one_sp)}
    tt.write_slot(tcache, tone, 1)
    for i in range(cfg.num_layers):
        _bits_equal(tcache["layers"][i]["k"], want["scan0"]["k"][i])
        _bits_equal(tcache["layers"][i]["v"], want["scan0"]["v"][i])
    np.testing.assert_array_equal(tcache["pos"].numpy(), want["pos"])
    np.testing.assert_array_equal(tcache["slot_pos"].numpy(),
                                  want["slot_pos"])


def test_write_slot_replaces_the_evicted_row(models):
    """A recycled slot holds exactly what a fresh admission writes; the
    neighbouring slot is untouched."""
    cfg, _, tp = models
    max_len, S = 24, 8
    prompts = torch.from_numpy(_prompts(cfg, 3, S, seed=4))
    cache = tt.init_slot_cache(cfg, 2, max_len, device="cpu")
    for slot in (0, 1):
        tm.prefill_into_slot(tp, cfg, cache, prompts[slot:slot + 1], slot,
                             max_len)
    tm.decode_steps(tp, cfg, cache, torch.full((2, 1), 5, dtype=torch.int32),
                    num_steps=3)
    neighbour = [(lc["k"][1].clone(), lc["v"][1].clone())
                 for lc in cache["layers"]]
    neighbour_pos = (int(cache["pos"][1]), cache["slot_pos"][1].clone())
    tm.prefill_into_slot(tp, cfg, cache, prompts[2:3], 0, max_len)
    fresh = tt.init_slot_cache(cfg, 2, max_len, device="cpu")
    tm.prefill_into_slot(tp, cfg, fresh, prompts[2:3], 0, max_len)
    for lc, lf, (nk, nv) in zip(cache["layers"], fresh["layers"], neighbour):
        assert torch.equal(lc["k"][0], lf["k"][0])
        assert torch.equal(lc["v"][0], lf["v"][0])
        assert torch.equal(lc["k"][1], nk) and torch.equal(lc["v"][1], nv)
    assert int(cache["pos"][0]) == int(fresh["pos"][0]) == S
    assert torch.equal(cache["slot_pos"][0], fresh["slot_pos"][0])
    assert int(cache["pos"][1]) == neighbour_pos[0]
    assert torch.equal(cache["slot_pos"][1], neighbour_pos[1])


# ---------------------------------------------------------------------------
# paged admission and copy-on-write
# ---------------------------------------------------------------------------


def test_prefill_into_paged_and_decode_window_match_jax(models):
    cfg, jp, tp = models
    C, bs, nb, S, max_len = 2, 4, 5, 8, 20
    N = C * nb + 1
    prompts = _prompts(cfg, C, S, seed=5)
    # permuted tables, longer than the prompt needs
    tables = np.random.default_rng(6).permutation(C * nb).astype(
        np.int32).reshape(C, nb)
    jc = jt.init_paged_cache(cfg, C, N, bs)
    tc = tt.init_paged_cache(cfg, C, N, bs, device="cpu")
    first = np.zeros((C, 1), np.int32)
    for slot in range(C):
        jc, jlog = jm.prefill_into_paged(
            jp, cfg, jc, {"tokens": jnp.asarray(prompts[slot:slot + 1])},
            slot, jnp.asarray(tables[slot]), max_len)
        tlog = tm.prefill_into_paged(
            tp, cfg, tc, torch.from_numpy(prompts[slot:slot + 1]), slot,
            torch.from_numpy(tables[slot]), max_len)
        _close(tlog, jlog)
        first[slot, 0] = int(np.asarray(jlog).argmax())
        assert int(tlog.argmax()) == first[slot, 0]
    assert tc["pos"].tolist() == [S, S]
    es.assert_kv(tc["layers"], jc, cfg)
    jtoks, jc = jm.decode_steps_paged(jp, cfg, jc, jnp.asarray(first),
                                      jnp.asarray(tables), num_steps=3)
    ttoks = tm.decode_steps_paged(tp, cfg, tc, torch.from_numpy(first),
                                  torch.from_numpy(tables), num_steps=3,
                                  use_kernels=False)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


def _pages(N, bs, seed):
    a = np.random.default_rng(seed).standard_normal((N, bs, 2, 8),
                                                    np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


@pytest.mark.parametrize("seq_len", [1, 8, 11])
def test_scatter_prefill_bit_equal(seq_len):
    pj, pt = _pages(9, 4, seed=7)
    seq = np.random.default_rng(8).standard_normal((14, 2, 8), np.float32)
    row = np.asarray([5, 0, 7, 2], np.int32)
    want = jpaged.scatter_prefill(pj, jnp.asarray(seq), jnp.asarray(row),
                                  seq_len)
    tpaged.scatter_prefill(pt, torch.from_numpy(seq), torch.from_numpy(row),
                           seq_len)
    _bits_equal(pt, want)


def test_copy_block_and_copy_paged_block_bit_equal(models):
    cfg = models[0]
    pj, pt = _pages(6, 4, seed=9)
    _bits_equal(pt, pj)
    want = jpaged.copy_block(pj, jnp.int32(4), jnp.int32(1))
    tpaged.copy_block(pt, 4, 1)
    _bits_equal(pt, want)
    N, bs = 7, 4
    shape = (cfg.num_layers, N, bs, cfg.num_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(10)
    k, v = (rng.standard_normal(shape, np.float32) for _ in range(2))
    pos = np.asarray([3, 9], np.int32)
    jcache = {"scan0": {"k": jnp.asarray(k).astype(jnp.bfloat16),
                        "v": jnp.asarray(v).astype(jnp.bfloat16)},
              "pos": jnp.asarray(pos)}
    tcache = {"layers": [{"k": torch.from_numpy(k[i]).to(torch.bfloat16),
                          "v": torch.from_numpy(v[i]).to(torch.bfloat16)}
                         for i in range(cfg.num_layers)],
              "pos": torch.from_numpy(pos.copy())}
    want = jt.copy_paged_block(jcache, jnp.int32(2), jnp.int32(5))
    tt.copy_paged_block(tcache, 2, 5)
    for i in range(cfg.num_layers):
        _bits_equal(tcache["layers"][i]["k"], want["scan0"]["k"][i])
        _bits_equal(tcache["layers"][i]["v"], want["scan0"]["v"][i])
    np.testing.assert_array_equal(tcache["pos"].numpy(), want["pos"])


def test_default_num_blocks_and_table_row_match_jax(models):
    for args in ((3, 14, 4), (16, 200, 16), (1, 3, 16), (5, 37, 8)):
        assert tpaged.default_num_blocks(*args) == \
            jpaged.default_num_blocks(*args)
    cfg = models[0]
    kvc = tpaged.PagedKVCache(cfg, num_slots=3, num_blocks=10,
                              block_size=4, max_len=14, device="cpu")
    jkvc = jpaged.PagedKVCache(cfg, num_slots=3, num_blocks=10,
                               block_size=4, max_len=14)
    for c in (kvc, jkvc):
        c.set_table(2, [6, 1, 8])
    for slot in range(3):
        row = kvc.table_row(slot)
        assert row.dtype == torch.int32
        np.testing.assert_array_equal(row.numpy(),
                                      np.asarray(jkvc.table_row(slot)))
