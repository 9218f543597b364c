"""PyTorch port: the kernel API (``repro_torch.kernels.ops``) and the plain
versions of its four ops-path kernels against the JAX package.

Each plain version is held against the Pallas kernel in interpret mode, as
tests/test_kernels.py runs it (``repro.kernels.ops.*(use_pallas=True,
interpret=True)``, with small tiles so the padded edges are exercised),
and against the JAX oracle in ``repro.kernels.ref``, on the same numpy
inputs, within the tolerances of tests/test_torch_kernels.py.  Then the
rules of the port that differ from the reference on purpose: an
all-masked decode row returns zeros, and the reference's
``flash_decode_attention(use_pallas=False)`` applies row 0's mask to every
row.  Last, the dispatch of the port's ``ops``, and the rule
(``kernels/compare.py``) that holds each CUDA kernel to its plain version.  The CUDA kernels are
tested on the card in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import chunked_prefill_attention as tcpa  # noqa: E402
from repro_torch.kernels import compare as tcmp  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode_attention as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rms_norm as trn  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # the reference kernel tests' tolerances: bf16 outputs round at
    # 2^-8 relative, float32 sums differ only in order
    return (dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def _pair(a: np.ndarray, dtype: str):
    """The same numpy data as a jnp and a torch array of ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, *wants, dtype):
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


# ---------------------------------------------------------------------------
# chunked-prefill attention over a paged prefix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KV,D,bs,T,ctxs,nb", [
    (4, 2, 16, 4, 5, [0, 7], 5),         # T not a multiple of bs
    (8, 1, 32, 8, 8, [13], 4),           # G = 8, one padding entry
    (6, 3, 8, 2, 3, [0, 1, 6], 6),       # query 0 of ctx 0 sees one key
])
def test_chunked_prefill_plain_vs_pallas_and_oracle(H, KV, D, bs, T, ctxs,
                                                    nb, dtype):
    B = len(ctxs)
    N = B * nb + 2
    rng = np.random.default_rng(T * 31 + nb)
    q_j, q_t = _pair(rng.standard_normal((B, T, H, D), np.float32), dtype)
    kp_j, kp_t = _pair(rng.standard_normal((N, bs, KV, D), np.float32),
                       dtype)
    vp_j, vp_t = _pair(rng.standard_normal((N, bs, KV, D), np.float32),
                       dtype)
    # every entry (the padding ones past ctx + T included) names a real
    # page: the mask, not the table, keeps the padding out
    tables = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    ctx = np.asarray(ctxs, np.int32)
    args_j = (q_j, kp_j, vp_j, jnp.asarray(tables), jnp.asarray(ctx))
    pallas = jops.chunked_prefill_attention(*args_j, use_pallas=True,
                                            interpret=True)
    oracle = jref.chunked_prefill_attention_ref(*args_j)
    before = tcpa.launches
    got = tcpa.chunked_prefill_attention(q_t, kp_t, vp_t,
                                         torch.from_numpy(tables),
                                         torch.from_numpy(ctx))
    assert tcpa.launches == before           # CPU: the plain version
    assert got.shape == q_t.shape and got.dtype == q_t.dtype
    _close(got, pallas, oracle, dtype=dtype)


# ---------------------------------------------------------------------------
# flash-decode attention over a contiguous cache with per-row masks
# ---------------------------------------------------------------------------


def _decode_case(B, S, H, KV, D, dtype, seed, empty_rows=()):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, H, D), np.float32), dtype)
    k = _pair(rng.standard_normal((B, S, KV, D), np.float32), dtype)
    v = _pair(rng.standard_normal((B, S, KV, D), np.float32), dtype)
    mask = rng.random((B, S)) < 0.6
    mask[:, 0] = True                        # no row empty by chance
    if B > 1:
        # a ring-style row: a hole in the middle of its valid slots
        mask[1] = True
        mask[1, S // 3:2 * S // 3] = False
    for b in empty_rows:
        mask[b] = False
    return q, k, v, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,D", [
    (3, 21, 4, 2, 16),                       # S not a multiple of the tile
    (2, 16, 4, 4, 32),                       # G = 1
])
def test_flash_decode_plain_vs_pallas_and_oracle(B, S, H, KV, D, dtype):
    (q_j, q_t), (k_j, k_t), (v_j, v_t), mask = _decode_case(
        B, S, H, KV, D, dtype, seed=S + H)
    pallas = jops.flash_decode_attention(q_j, k_j, v_j, jnp.asarray(mask),
                                         block_k=8, use_pallas=True,
                                         interpret=True)
    oracle = jref.decode_attention_ref(q_j, k_j, v_j,
                                       mask=jnp.asarray(mask))
    before = tfd.launches
    got = tfd.flash_decode_attention(q_t, k_t, v_t, torch.from_numpy(mask))
    assert tfd.launches == before
    assert got.shape == q_t.shape and got.dtype == q_t.dtype
    _close(got, pallas, oracle, dtype=dtype)


def test_flash_decode_all_masked_row_returns_zeros():
    """The port's rule for a row with nothing to attend: zeros.  The JAX
    oracle returns the uniform average of the row's values instead, and
    the Pallas kernel (no re-mask after the max shift) an average that
    depends on the padding of its last tile (ROADMAP Queue 3)."""
    B, S, H, KV, D = 3, 21, 4, 2, 16
    (q_j, q_t), (k_j, k_t), (v_j, v_t), mask = _decode_case(
        B, S, H, KV, D, "float32", seed=3, empty_rows=(2,))
    got = tfd.flash_decode_attention(q_t, k_t, v_t, torch.from_numpy(mask))
    np.testing.assert_array_equal(got[2].numpy(), np.zeros((H, D)))
    oracle = _np(jref.decode_attention_ref(q_j, k_j, v_j,
                                           mask=jnp.asarray(mask)))
    uniform = np.repeat(np.asarray(v_j)[2].mean(axis=0), H // KV, axis=0)
    np.testing.assert_allclose(oracle[2], uniform, atol=2e-5)
    pallas = _np(jops.flash_decode_attention(
        q_j, k_j, v_j, jnp.asarray(mask), block_k=8, use_pallas=True,
        interpret=True))
    assert np.abs(pallas[2]).max() > 1e-3
    # the rows with valid slots agree with both, as everywhere else
    np.testing.assert_allclose(got[:2].numpy(), oracle[:2], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got[:2].numpy(), pallas[:2], atol=2e-5,
                               rtol=2e-5)


def test_reference_plain_decode_applies_row_zero_mask_to_every_row():
    """``repro.kernels.ops.flash_decode_attention(use_pallas=False)``
    builds its positions from ``mask[0]`` (ops.py:64): with rows whose
    masks differ it disagrees with the oracle.  The port's plain version
    is the oracle's."""
    B, S, H, KV, D = 3, 21, 4, 2, 16
    (q_j, q_t), (k_j, k_t), (v_j, v_t), mask = _decode_case(
        B, S, H, KV, D, "float32", seed=4)
    assert not (mask == mask[0]).all()
    oracle = _np(jref.decode_attention_ref(q_j, k_j, v_j,
                                           mask=jnp.asarray(mask)))
    trap = _np(jops.flash_decode_attention(q_j, k_j, v_j, jnp.asarray(mask),
                                           use_pallas=False))
    np.testing.assert_allclose(trap[0], oracle[0], atol=2e-5, rtol=2e-5)
    assert np.abs(trap[1:] - oracle[1:]).max() > 1e-2
    got = tops.flash_decode_attention(q_t, k_t, v_t, torch.from_numpy(mask),
                                      use_kernels=False)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# flash attention (prefill), GQA, causal and sliding window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (1, 13, 4, 4, 16, True, None),           # G = 1, S not a multiple of 8
    (2, 21, 8, 2, 16, True, 5),              # G = 4, windowed
    (1, 19, 4, 1, 8, False, None),           # non-causal
    (1, 11, 4, 2, 16, False, 4),             # non-causal, windowed
])
def test_flash_attention_plain_vs_pallas_and_oracle(B, S, H, KV, D, causal,
                                                    window, dtype):
    rng = np.random.default_rng(S * 7 + H)
    q_j, q_t = _pair(rng.standard_normal((B, S, H, D), np.float32), dtype)
    k_j, k_t = _pair(rng.standard_normal((B, S, KV, D), np.float32), dtype)
    v_j, v_t = _pair(rng.standard_normal((B, S, KV, D), np.float32), dtype)
    pallas = jops.flash_attention(q_j, k_j, v_j, causal=causal,
                                  window=window, block_q=8, block_k=8,
                                  use_pallas=True, interpret=True)
    oracle = jref.attention_ref(q_j, k_j, v_j, causal=causal, window=window)
    before = tfa.launches
    got = tfa.flash_attention(q_t, k_t, v_t, causal=causal, window=window)
    assert tfa.launches == before
    assert got.shape == q_t.shape and got.dtype == q_t.dtype
    _close(got, pallas, oracle, dtype=dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(13, 32), (2, 5, 48)])
def test_rms_norm_plain_vs_pallas_and_oracle(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x_j, x_t = _pair(rng.standard_normal(shape, np.float32) * 2, dtype)
    w_j, w_t = _pair(rng.standard_normal(shape[-1:], np.float32) * 0.1,
                     dtype)
    pallas = jops.rms_norm(x_j, w_j, eps=1e-6, block_rows=8,
                           use_pallas=True, interpret=True)
    oracle = jref.rms_norm_ref(x_j, w_j, 1e-6)
    before = trn.launches
    got = trn.rms_norm(x_t, w_t, 1e-6)
    assert trn.launches == before
    assert got.shape == x_t.shape and got.dtype == x_t.dtype
    _close(got, pallas, oracle, dtype=dtype)


# ---------------------------------------------------------------------------
# dispatch of the port's ops
# ---------------------------------------------------------------------------


def _ops_calls():
    """Each of the six ops on small CPU inputs, with its plain version."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    tab = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    pages = (r(5, 4, 2, 8), r(5, 4, 2, 8))
    mask = torch.tensor([[True, False, True], [False, True, True]])
    meta = torch.tensor([[0, 2, 3, 0], [1, 0, 2, 3]], dtype=torch.int32)
    kv_new = (r(2, 4, 2, 8), r(2, 4, 2, 8))
    return [
        (tops.flash_attention, (r(1, 6, 4, 8), r(1, 6, 2, 8), r(1, 6, 2, 8)),
         dict(window=3), tref.attention_ref),
        (tops.flash_decode_attention, (r(2, 4, 8), r(2, 3, 2, 8),
                                       r(2, 3, 2, 8), mask), {},
         tref.decode_attention_ref),
        (tops.paged_decode_attention, (r(2, 4, 8), *pages, tab, lens), {},
         tref.paged_decode_attention_ref),
        (tops.chunked_prefill_attention, (r(2, 3, 4, 8), *pages, tab, lens),
         {}, tref.chunked_prefill_attention_ref),
        (tops.ragged_chunked_prefill, (r(2, 4, 4, 8), *kv_new, *pages, tab,
                                       meta), {},
         tref.ragged_chunked_prefill_ref),
        (tops.rms_norm, (r(3, 8), r(8)), dict(eps=1e-5),
         lambda x, w, eps: tref.rms_norm_ref(x, w, eps)),
    ]


@pytest.mark.parametrize("i", range(6), ids=[
    "flash_attention", "flash_decode_attention", "paged_decode_attention",
    "chunked_prefill_attention", "ragged_chunked_prefill", "rms_norm"])
def test_ops_dispatch_on_cpu(i):
    """``None`` and ``False`` on CPU tensors give the plain version (the
    ragged op returns its in-place pools beside the output, as the
    reference returns new ones); ``True`` raises: there is no kernel on
    the CPU and no silent fallback."""
    fn, args, kw, plain = _ops_calls()[i]
    clone = lambda: [a.clone() for a in args]  # noqa: E731
    want = plain(*clone(), **kw)
    for use_kernels in (None, False):
        got = fn(*clone(), **kw, use_kernels=use_kernels)
        if isinstance(got, tuple):
            assert len(got) == 3
            got = got[0]
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="use_kernels=True"):
        fn(*clone(), **kw, use_kernels=True)


def test_ragged_op_returns_its_updated_pools():
    fn, args, kw, plain = _ops_calls()[4]
    args = [a.clone() for a in args]
    out, kp, vp = fn(*args)
    assert kp is args[3] and vp is args[4]
    ref_pages = [a.clone() for a in _ops_calls()[4][1]]
    plain(*ref_pages)
    assert torch.equal(kp, ref_pages[3]) and torch.equal(vp, ref_pages[4])


def test_new_wrappers_refuse_other_devices():
    x = torch.empty((2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        trn.rms_norm(x, torch.empty((32,), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(x[None], x[None], x[None])
    with pytest.raises(ValueError, match="no kernel"):
        tfd.flash_decode_attention(x, x[:, None], x[:, None],
                                   torch.empty((2, 1), dtype=torch.bool,
                                               device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tcpa.chunked_prefill_attention(
            x[None], x[None], x[None],
            torch.empty((1, 2), dtype=torch.int32, device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"))


def test_decode_mask_must_be_one_row_per_sequence():
    """The plain version takes exactly the kernel's mask shape, (B, S)."""
    q, kc = torch.zeros((2, 4, 8)), torch.zeros((2, 5, 2, 8))
    with pytest.raises(ValueError, match="mask"):
        tops.flash_decode_attention(q, kc, kc, torch.ones(5,
                                                          dtype=torch.bool))


# ---------------------------------------------------------------------------
# the kernel-vs-plain rule
# ---------------------------------------------------------------------------


def _attention_f64(q, k, v, mask):
    """Attention in float64 (another order of summation than the plain
    version's float32), rounded to q's dtype: what a correct kernel may
    return.  q (B, Sq, H, D); k/v (B, L, KV, D); mask (B, Sq, L)."""
    G = q.shape[2] // k.shape[2]
    kf = torch.repeat_interleave(k.double(), G, dim=2)
    vf = torch.repeat_interleave(v.double(), G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kf) / q.shape[-1] ** 0.5
    p = torch.softmax(s.masked_fill(~mask[:, None], -1e300), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


@pytest.mark.parametrize("case", ["window", "causal", "decode_length"])
def test_compare_rule_holds_rounding_and_refuses_a_one_key_mask_edge(case):
    """bf16 rounding of a differently ordered sum uses at most 0.4 of the
    limit (it is sized at four times the worst one-ulp gap); attending
    one key too many or too few at a mask edge exceeds it."""
    rng = np.random.default_rng(11)
    S, H, KV, D, W = 384, 4, 1, 64, 256
    bf16 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s, np.float32)).bfloat16()
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    if case == "decode_length":              # S rows of one token each
        q, k, v = bf16(S, 1, H, D), bf16(S, S, KV, D), bf16(S, S, KV, D)
        lens = torch.arange(S)[:, None] // 2 + 1
        right = j < lens
        wrong = j < lens + (lens > 32)       # one slot too many
        plain = tref.decode_attention_ref(q[:, 0], k, v, right)[:, None]
        right, wrong = right[:, None], wrong[:, None]
    else:
        q, k, v = bf16(1, S, H, D), bf16(1, S, KV, D), bf16(1, S, KV, D)
        if case == "window":
            plain = tref.attention_ref(q, k, v, causal=True, window=W)
            right = (j <= i) & (i - j < W)
            wrong = (j <= i) & (i - j < W + 1)   # one key past the window
        else:
            plain = tref.attention_ref(q, k, v, causal=True)
            right = j <= i
            wrong = (j < i) | (j == 0)           # each row misses itself
        right, wrong = right[None], wrong[None]
    assert tcmp.compare(_attention_f64(q, k, v, right), plain)[1] <= 0.4
    assert tcmp.within(_attention_f64(q, k, v, right), plain)
    assert not tcmp.within(_attention_f64(q, k, v, wrong), plain)


def test_compare_rule_on_zeros_and_non_finite_outputs():
    z = torch.zeros((2, 3))
    assert tcmp.compare(z, z) == (0.0, 0.0)
    assert tcmp.compare(z + 1e-3, z)[1] == float("inf")
    bad = torch.ones((2, 3))
    bad[1, 2] = float("nan")
    assert not tcmp.within(bad, torch.ones((2, 3)))
    with pytest.raises(ValueError, match="shapes"):
        tcmp.compare(z, z[0])
