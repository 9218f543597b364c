"""PyTorch port: the design of the two tensor-core attention kernels,
checked on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
What their design rests on is plain arithmetic and host code, held here:

  * the split-K flash decode (csrc/flash_decode_attention.cu): its two
    passes modelled in ``ref.decode_split_partials`` and
    ``ref.combine_split_partials``, against the port's oracle
    (``ref.decode_attention_ref``) and the JAX Pallas kernel in interpret
    mode, with all-masked splits and rows;
  * the host's split plan (``flash_decode_attention.split_plan``): CTA
    counts, the shortest split, one split at small S;
  * the P . V precision of the flash-attention kernel
    (csrc/mma_attn.cuh): an emulation of its online softmax with P as
    bf16 hi + lo stays within half of ``kernels/compare.py``'s limit,
    where the same emulation with P rounded to bf16 alone does not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import compare as tcmp  # noqa: E402
from repro_torch.kernels import flash_decode_attention as tfd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# ---------------------------------------------------------------------------
# split-K flash decode: the plain model of the two passes
# ---------------------------------------------------------------------------

TILE = 4                  # small tiles, so a 37-slot row has ten of them


def _decode_case(seed: int):
    """B = 4 rows over S = 37 slots: row 0 with slots 8..23 masked (whole
    splits at n_splits = 5), row 1 valid only in slots 0..2 (every later
    split masked), row 2 random, row 3 all masked."""
    B, S, H, KV, D = 4, 37, 4, 2, 16
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    k = rng.standard_normal((B, S, KV, D), np.float32)
    v = rng.standard_normal((B, S, KV, D), np.float32)
    mask = rng.random((B, S)) < 0.7
    mask[:3, 0] = True
    mask[0, 8:24] = False
    mask[1, 3:] = False
    mask[3] = False
    return q, k, v, mask


@pytest.mark.parametrize("n_splits", [1, 2, 5])
def test_split_partials_combine_to_the_oracle_and_pallas(n_splits):
    q, k, v, mask = _decode_case(seed=n_splits)
    qt, kt, vt, mt = (torch.from_numpy(a) for a in (q, k, v, mask))
    m, l, acc = tref.decode_split_partials(qt, kt, vt, mt, n_splits,
                                           tile=TILE)
    assert m.shape == l.shape == (4, 4, n_splits)
    assert acc.shape == (4, 4, n_splits, 16)
    got = tref.combine_split_partials(m, l, acc)
    assert torch.isfinite(got).all()
    # the port's oracle, every row (an all-masked row: zeros in both)
    np.testing.assert_allclose(
        got.numpy(), tref.decode_attention_ref(qt, kt, vt, mt).numpy(),
        atol=2e-6, rtol=2e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.zeros((4, 16)))
    # the JAX oracle and the Pallas kernel, on the rows with a valid slot
    # (on an all-masked row both average the values instead: ROADMAP
    # Queue 3)
    jm = jnp.asarray(mask)
    pallas = np.asarray(jops.flash_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, block_k=8,
        use_pallas=True, interpret=True))
    oracle = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm))
    for want in (pallas, oracle):
        np.testing.assert_allclose(got[:3].numpy(), want[:3], atol=2e-5,
                                   rtol=2e-5)


def test_split_partials_of_masked_and_empty_ranges():
    """A range with no valid slot gives m = NEG_INF, l = 0, acc = 0, and a
    range past the end of S (more splits than tiles) the same."""
    q, k, v, mask = _decode_case(seed=7)
    qt, kt, vt, mt = (torch.from_numpy(a) for a in (q, k, v, mask))
    m, l, acc = tref.decode_split_partials(qt, kt, vt, mt, 12, tile=TILE)
    # per = 4 slots: row 0's ranges 2..5 (slots 8..23) are masked, row 1's
    # ranges 1.., row 3's all; ranges 10, 11 start past S = 37
    for row, ranges in ((0, range(2, 6)), (1, range(1, 12)),
                        (3, range(12)), (2, range(10, 12))):
        for i in ranges:
            assert (m[row, :, i] == tref.NEG_INF).all()
            assert (l[row, :, i] == 0).all() and (acc[row, :, i] == 0).all()
    assert (l[0, :, 0] > 0).all() and (l[2, :, 9] >= 0).all()
    got = tref.combine_split_partials(m, l, acc)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[3].numpy(), np.zeros((4, 16)))
    np.testing.assert_allclose(
        got.numpy(), tref.decode_attention_ref(qt, kt, vt, mt).numpy(),
        atol=2e-6, rtol=2e-6)


# ---------------------------------------------------------------------------
# split-K flash decode: the host's split plan
# ---------------------------------------------------------------------------


def test_split_plan_at_the_timed_shape():
    """B 16, S 2048, KV 2 (starcoder2-3b, G = 12) on 132 SMs: 8 splits of
    4 tiles, 2 x 16 x 8 = 256 CTAs, about two per SM."""
    assert tfd.split_plan(16, 24, 2, 2048, 132) == (8, 4)


@pytest.mark.parametrize("B,H,KV,S,sms", [
    (16, 24, 2, 2048, 132),
    (1, 24, 2, 2048, 132),                   # one row: one tile a split
    (2, 24, 2, 1000, 132),
    (3, 32, 8, 300, 132),
    (2, 16, 1, 500, 132),                    # G = 16: one row block
    (2, 48, 1, 777, 132),                    # G = 48: three row blocks
    (64, 32, 8, 32768, 132),                 # groups fill the card alone
    (8, 24, 2, 100, 132),
    (4, 8, 2, 65, 7),
])
def test_split_plan_bounds(B, H, KV, S, sms):
    n, per = tfd.split_plan(B, H, KV, S, sms)
    n_tiles = -(-S // tfd.TILE)
    groups = B * KV * -(-(H // KV) // tfd.ROW_BLOCK)
    assert n >= 1 and per >= 1               # no split under one tile
    assert n * per >= n_tiles > (n - 1) * per    # covers S, none empty
    # about CTAS_PER_SM per SM where S allows, never far above it
    assert groups * n <= max(groups, tfd.CTAS_PER_SM * sms) * 2
    if n < n_tiles:
        assert groups * n > tfd.CTAS_PER_SM * sms // 2


@pytest.mark.parametrize("S", [1, 17, 64])
def test_split_plan_takes_one_split_at_small_s(S):
    assert tfd.split_plan(16, 24, 2, S, 132) == (1, 1)
    assert tfd.split_plan(1, 24, 2, S, 132) == (1, 1)


def test_split_plan_takes_one_split_when_the_groups_fill_the_card():
    n_tiles = -(-4096 // tfd.TILE)
    assert tfd.split_plan(128, 32, 8, 4096, 132) == (1, n_tiles)


# ---------------------------------------------------------------------------
# flash attention: the precision of P . V
# ---------------------------------------------------------------------------


def _emulate_flash_attention(q, k, v, causal, window, pv, tile=64):
    """The tensor-core kernel's arithmetic on the CPU: 64-key tiles, Q K^T
    from bf16 operands summed in float32, the online softmax in base 2 in
    float32, and P . V with P as ``pv``: ``"hi_lo"`` (bf16(P) and
    bf16(P - bf16(P)), two products into one float32 accumulator, as
    csrc/mma_attn.cuh does) or ``"bf16"`` (bf16(P) alone)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = torch.repeat_interleave(k.float(), G, 2).permute(0, 2, 1, 3)
    vf = torch.repeat_interleave(v.float(), G, 2).permute(0, 2, 1, 3)
    scale_log2 = np.log2(np.e) / D ** 0.5
    m = torch.full((B, H, S, 1), float("-inf"))
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, D))
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, tile):
        kp = torch.arange(k0, min(S, k0 + tile))[None, :]
        valid = torch.ones((S, kp.shape[1]), dtype=torch.bool)
        if causal:
            valid &= kp <= qp
        if window is not None:
            valid &= qp - kp < window
        s = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale_log2
        s = torch.where(valid, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + tile]
        hi = p.bfloat16().float()
        o = o * corr + hi @ vt
        if pv == "hi_lo":
            o = o + (p - hi).bfloat16().float() @ vt
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("S,H,D,window", [
    (2048, 4, 128, None),                    # causal, starcoder2-3b's D
    (1536, 4, 120, 512),                     # windowed, h2o-danube's D
])
def test_hi_lo_probabilities_keep_half_the_limit(S, H, D, window, seed):
    """P as bf16 hi + lo stays within half of the kernel-vs-plain limit;
    P rounded to bf16 alone uses more than half of it (and crosses it as
    the number of output elements grows).  This is why the kernel runs
    two bf16 products for P . V."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, S, H, D), np.float32)).bfloat16() for _ in range(3))
    plain = tref.attention_ref(q, k, v, causal=True, window=window)
    hi_lo = _emulate_flash_attention(q, k, v, True, window, "hi_lo")
    bf16 = _emulate_flash_attention(q, k, v, True, window, "bf16")
    assert tcmp.compare(hi_lo, plain)[1] <= 0.5
    assert tcmp.compare(bf16, plain)[1] > 0.5


# ---------------------------------------------------------------------------
# the head dims the tensor-core kernels are built for
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D,padded", [
    (32, 32), (64, 64), (112, 128), (120, 128), (128, 128), (256, 256),
    (8, 32), (40, 64), (200, 256),
])
def test_every_config_head_dim_has_an_instance(D, padded):
    """Each head dim of the configs (32, 64, 112, 120, 128, 256) maps to
    a compile-time width that holds it; the pad is zeros in the tiles."""
    from repro_torch.kernels import _build
    assert _build.padded_head_dim(D) == padded


def test_every_attention_config_is_taken(monkeypatch):
    """Every config with attention heads, at full width and as a smoke
    config, has a head dim the tensor-core kernels take, and the two
    prefill wrappers launch at it (the launch stubbed: no card here)."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels import chunked_prefill_attention as tcpa
    from repro_torch.kernels import ragged_chunked_prefill as trcp
    launched = []
    monkeypatch.setattr(_build, "on_card", lambda x: True)
    monkeypatch.setattr(_build, "launch",
                        lambda module, symbol, argtypes, *args, device:
                        launched.append(module.NAME))
    dims = set()
    for arch in configs.ARCH_IDS:
        for cfg in (configs.get_config(arch), configs.get_smoke_config(arch)):
            if getattr(cfg, "num_heads", 0) and getattr(cfg, "head_dim", 0):
                dims.add(cfg.head_dim)
                assert _build.padded_head_dim(cfg.head_dim) >= cfg.head_dim
    for Dc in sorted(dims):
        z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
        tab = torch.zeros((1, 1), dtype=torch.int32)
        trcp.ragged_chunked_prefill(
            z(1, 2, 2, Dc), z(1, 2, 1, Dc), z(1, 2, 1, Dc), z(1, 16, 1, Dc),
            z(1, 16, 1, Dc), tab, torch.tensor([[0, 0, 2, 0]],
                                               dtype=torch.int32))
        tcpa.chunked_prefill_attention(z(1, 2, 2, Dc), z(1, 16, 1, Dc),
                                       z(1, 16, 1, Dc), tab, tab[:, 0])
    assert launched == ["ragged_chunked_prefill",
                        "chunked_prefill_attention"] * len(dims)
    assert {32, 64, 112, 120, 128, 256} <= dims


@pytest.mark.parametrize("D", [0, 100, 124, 264])
def test_head_dims_the_kernels_do_not_take_raise(D):
    from repro_torch.kernels import _build
    with pytest.raises(ValueError, match="head dim"):
        _build.padded_head_dim(D)
