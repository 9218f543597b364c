"""PyTorch port: the CUDA kernels against their plain versions, on the card,
the continuous engine's CUDA graphs against eager dispatch, and a traced
serve's stream on the card against the CPU's.

Needs a CUDA card (and ``nvcc`` to build the kernels); every test carries
the ``cuda`` marker and skips with a reason elsewhere.  The file imports
only ``torch`` and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import chunked_prefill_attention as tcpa  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import flash_decode_attention as tfd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpfd  # noqa: E402
from repro_torch.kernels import ragged_chunked_prefill as trcp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rms_norm as trn  # noqa: E402
from repro_torch.kernels.compare import within  # noqa: E402

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [0, 3])
@pytest.mark.parametrize("D", [64, 120, 128])
@pytest.mark.parametrize("bs,nb", [(16, 6), (16, 20), (48, 7)])
def test_cuda_paged_decode_kernel_matches_plain(cuda, monkeypatch, bs, nb,
                                                D, n_splits):
    """Permuted tables, lengths 0 (zeros), 1, 37 and the whole table; the
    card's own split plan (``n_splits`` 0), then the plan for an SM count
    that aims at 3 splits (as many as the table has tiles, where fewer):
    splits wholly past a short sequence write empty partials.  bs 48
    does not divide the 64-slot tile."""
    _check_paged_decode(cuda, monkeypatch, 4, 24, 2, D, bs, nb, n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [0, 3])
@pytest.mark.parametrize("bs,nb", [(16, 6), (16, 20), (48, 7)])
def test_cuda_paged_decode_kernel_matches_plain_at_kimi_heads(
        cuda, monkeypatch, bs, nb, n_splits):
    """The same cases at kimi-k2-1t-a32b's attention shape on the engine
    path: 16 slots, D 112, H 64, KV 8 (ROADMAP K5)."""
    _check_paged_decode(cuda, monkeypatch, 16, 64, 8, 112, bs, nb, n_splits)


def _check_paged_decode(cuda, monkeypatch, B, H, KV, D, bs, nb, n_splits):
    N = B * nb + 1
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    vp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    tab = torch.randperm(N - 1, generator=g, device=cuda)[:B * nb].view(
        B, nb).int()
    lens = torch.tensor(([0, 1, 37, nb * bs] * B)[:B], dtype=torch.int32,
                        device=cuda)
    n_tiles = -(-nb * bs // tfd.TILE)
    if n_splits:
        groups = B * KV * -(-(H // KV) // tfd.ROW_BLOCK)
        sms = -(-n_splits * groups // tfd.CTAS_PER_SM)
        monkeypatch.setattr(tfd, "_sm_count", lambda _device: sms)
        assert tfd.split_plan(B, H, KV, nb * bs, sms)[0] == min(n_splits,
                                                                n_tiles)
    before = tpfd.launches
    out = tpfd.paged_flash_decode_attention(q, kp, vp, tab, lens)
    torch.cuda.synchronize()
    assert tpfd.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert within(out, tpfd.paged_decode_attention_ref(q, kp, vp, tab,
                                                       lens))
    assert out[0].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [100, 264])
def test_cuda_paged_decode_refuses_other_head_dims(cuda, D):
    """A head dim the kernel is not built for raises before any launch."""
    q = torch.zeros((2, 4, D), device=cuda, dtype=torch.bfloat16)
    pages = torch.zeros((5, 16, 2, D), device=cuda, dtype=torch.bfloat16)
    tab = torch.zeros((2, 2), dtype=torch.int32, device=cuda)
    lens = torch.ones((2,), dtype=torch.int32, device=cuda)
    before = tpfd.launches
    with pytest.raises(ValueError, match="head dim"):
        tpfd.paged_flash_decode_attention(q, pages, pages, tab, lens)
    assert tpfd.launches == before


#: (ctx_len, chunk_len) of the ragged cases' chunks, in turn: a prefix not
#: a multiple of the 64-position tile, first chunks, a one-token chunk, a
#: long prefix, and a chunk_len == 0 padding chunk (T_pad = 32)
RAGGED_CHUNKS = [(40, 32), (0, 7), (1, 1), (70, 29), (0, 0)]


def _dead_rows(out_c, clen, G):
    """The rows of one chunk's output (T, H, D) in 16-row t-major tiles
    wholly at t >= clen, per KV group: they must be zeros."""
    T, H, D = out_c.shape
    rows = out_c.reshape(T, H // G, G, D).transpose(0, 1).reshape(
        H // G, T * G, D)
    return rows[:, -(-clen * G // 16) * 16:]


def _trash_past(tab, last_pos, bs):
    """A copy of table row(s) whose entries past the page of position
    ``last_pos`` are page ids far outside the pool: a kernel that read
    one would fault."""
    t = tab.clone()
    t[last_pos // bs + 1:] = 1 << 30
    return t


#: (layout, bs, D, H, KV, C): "original" is the first version's case
#: (seed 1, arange tables, three chunks of which the last pads), "cycled"
#: the chunks of ``RAGGED_CHUNKS`` in turn
RAGGED_CASES = [("original", 16, 128, 24, 2, 3)] + [
    ("cycled", bs, D, H, KV, C) for bs in (16, 48)
    for D in (64, 112, 120, 128, 256) for H, KV in ((24, 2), (4, 4))
    for C in (3, 16)] + [
    # kimi-k2-1t-a32b's attention shape on the engine path (ROADMAP K5)
    ("cycled", 16, 112, 64, 8, C) for C in (3, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,bs,D,H,KV,C", RAGGED_CASES)
def test_cuda_ragged_prefill_kernel_matches_plain(cuda, layout, bs, D, H,
                                                  KV, C):
    """The original case, then chunks cycling through ``RAGGED_CHUNKS``
    (C = 16 holds three padding chunks, whose tables are all the trash
    page), each real chunk's table entries past its last position trashed
    for the kernel (the plain version reads every entry, so it gets the
    valid ones).  Pages bit-equal to the plain version's, the trash page
    untouched, live rows within the compare limit, dead tiles' rows
    zero."""
    T = 32
    G = H // KV
    if layout == "original":
        nb = 8
        seed = 1
    else:
        chunks = [RAGGED_CHUNKS[c % len(RAGGED_CHUNKS)] for c in range(C)]
        nb = -(-(70 + 32) // bs) + 1
        seed = bs * 1000 + D + G + C
    N = C * nb + 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((C, T, H, D), generator=g, device=cuda).bfloat16()
    kn = torch.randn((C, T, KV, D), generator=g, device=cuda).bfloat16()
    vn = torch.randn((C, T, KV, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    vp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    if layout == "original":
        tab = torch.arange(C * nb, device=cuda, dtype=torch.int32).view(C,
                                                                        nb)
        tab[2] = N - 1
        kern_tab = tab
        meta = torch.tensor([[0, 40, 32, 0], [1, 0, 7, 32], [3, 0, 0, 39]],
                            dtype=torch.int32, device=cuda)
        chunks = [(40, 32), (0, 7), (0, 0)]
    else:
        tab = torch.randperm(N - 1, generator=g, device=cuda)[:C * nb].view(
            C, nb).int()
        kern_tab = tab.clone()
        meta = torch.zeros((C, 4), dtype=torch.int32, device=cuda)
        off = 0
        for c, (ctx, ln) in enumerate(chunks):
            meta[c] = torch.tensor([c, ctx, ln, off])
            off += ln
            if ln == 0:
                tab[c] = N - 1
                kern_tab[c] = N - 1
            else:
                kern_tab[c] = _trash_past(tab[c], ctx + ln - 1, bs)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    before = trcp.launches
    out = trcp.ragged_chunked_prefill(q, kn, vn, k1, v1, kern_tab, meta)
    torch.cuda.synchronize()
    assert trcp.launches == before + 1
    want = trcp.ragged_chunked_prefill_ref(q, kn, vn, k2, v2, tab, meta)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.equal(k1[N - 1], kp[N - 1])
    assert torch.isfinite(out.float()).all()
    for c, (_, ln) in enumerate(chunks):
        if ln:
            assert within(out[c, :ln], want[c, :ln])
        assert not _dead_rows(out[c], ln, G).any()


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda):
    """No fallback: a dtype the kernel does not take raises on the card."""
    q = torch.zeros((2, 4, 32), device=cuda)
    pages = torch.zeros((6, 16, 2, 32), device=cuda)
    tab = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    lens = torch.ones((2,), dtype=torch.int32, device=cuda)
    before = tpfd.launches
    with pytest.raises(TypeError, match="bfloat16"):
        tpfd.paged_flash_decode_attention(q, pages, pages, tab, lens)
    assert tpfd.launches == before


@pytest.mark.cuda
def test_cuda_model_decode_goes_through_the_kernel(cuda):
    """One paged decode step of the smoke model launches the kernel once
    per layer with ``use_kernels=True`` and never with ``False``; the two
    paths' logits agree to bf16 rounding carried through two layers (bf16
    logits: a few ulps of the largest, 2^-8 relative each)."""
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    cfg = configs.get_smoke_config("starcoder2-3b")
    params = model_lib.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tables = torch.arange(8, dtype=torch.int32, device=cuda).view(2, 4)
    token = torch.tensor([[5], [7]], dtype=torch.int32, device=cuda)
    logits = {}
    for use_kernels in (True, False):
        cache = transformer.init_paged_cache(cfg, 2, 9, 4, device=cuda)
        cache["pos"].fill_(3)
        before = tpfd.launches
        _, logits[use_kernels] = model_lib.decode_step_paged(
            params, cfg, cache, token, tables, use_kernels=use_kernels)
        torch.cuda.synchronize()
        launched = tpfd.launches - before
        assert launched == (cfg.num_layers if use_kernels else 0)
    scale = float(logits[False].abs().max())
    assert float((logits[True] - logits[False]).abs().max()) <= 0.05 * scale


#: (layout, bs, D, H, KV, T): "original" is the first version's case
#: (seed 2, 5-entry tables, contexts 0, 5, 16, 33), "wide" five contexts
#: up to 70 with tables trashed past each one's last position
CHUNKED_CASES = [("original", 16, 128, 24, 2, 9)] + [
    ("wide", bs, D, H, KV, T) for bs in (16, 48)
    for D in (64, 112, 120, 128, 256) for H, KV in ((24, 2), (4, 4))
    for T in (9, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,bs,D,H,KV,T", CHUNKED_CASES)
def test_cuda_chunked_prefill_kernel_matches_plain(cuda, layout, bs, D, H,
                                                   KV, T):
    """Sequences at contexts 0, 5, 16 (a chunk starting on a page
    boundary at bs 16), 33 and 70 (not multiples of the block or the
    64-position tile; T = 9 is not a multiple of the 16-row tile), through
    ``ops``; in the wide cases each table's entries past its last position
    are trashed for the kernel (the plain version reads every entry)."""
    if layout == "original":
        ctxs, nb, seed = (0, 5, 16, 33), 5, 2
    else:
        ctxs = (0, 5, 16, 33, 70)
        nb = -(-(70 + T) // bs) + 1
        seed = bs * 1000 + D + H + T
    B = len(ctxs)
    N = B * nb + 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, T, H, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    vp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    tab = torch.randperm(N, generator=g, device=cuda)[:B * nb].view(
        B, nb).int()
    kern_tab = tab if layout == "original" else torch.stack(
        [_trash_past(tab[b], c + T - 1, bs) for b, c in enumerate(ctxs)])
    ctx = torch.tensor(ctxs, dtype=torch.int32, device=cuda)
    before = tcpa.launches
    out = ops.chunked_prefill_attention(q, kp, vp, kern_tab, ctx)
    torch.cuda.synchronize()
    assert tcpa.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert within(out, ref.chunked_prefill_attention_ref(q, kp, vp, tab,
                                                          ctx))


@pytest.mark.cuda
@pytest.mark.parametrize("kmod", [trcp, tcpa])
def test_cuda_prefill_kernels_have_the_tile_models_cta(cuda, kmod):
    """The CTA size each prefill library was built with is the plain tile
    model's (``ref.ragged_prefill_tiles`` stores tokens by it)."""
    assert (_build.load(kmod.NAME).rtlm_prefill_cta_rows()
            == ref.PREFILL_CTA_ROWS)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [100, 264])
def test_cuda_prefill_kernels_refuse_other_head_dims(cuda, D):
    """A head dim the prefill kernels are not built for raises before any
    launch."""
    q = torch.zeros((1, 4, 4, D), device=cuda, dtype=torch.bfloat16)
    kn = torch.zeros((1, 4, 2, D), device=cuda, dtype=torch.bfloat16)
    pages = torch.zeros((3, 16, 2, D), device=cuda, dtype=torch.bfloat16)
    tab = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    meta = torch.tensor([[0, 0, 4, 0]], dtype=torch.int32, device=cuda)
    before = (trcp.launches, tcpa.launches)
    with pytest.raises(ValueError, match="head dim"):
        trcp.ragged_chunked_prefill(q, kn, kn, pages, pages, tab, meta)
    with pytest.raises(ValueError, match="head dim"):
        tcpa.chunked_prefill_attention(q, pages, pages, tab, meta[:, 1])
    assert (trcp.launches, tcpa.launches) == before


@pytest.mark.cuda
def test_cuda_flash_decode_kernel_matches_plain(cuda):
    """Per-row masks over S = 100 (no multiple of the tile), one row with
    a hole in the middle, one all-masked row (zeros)."""
    B, S, H, KV, D = 4, 100, 24, 2, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((B, H, D), generator=g, device=cuda).bfloat16()
    kc = torch.randn((B, S, KV, D), generator=g, device=cuda).bfloat16()
    vc = torch.randn((B, S, KV, D), generator=g, device=cuda).bfloat16()
    mask = torch.rand((B, S), generator=g, device=cuda) < 0.5
    mask[1] = True
    mask[1, 30:70] = False
    mask[3] = False
    before = tfd.launches
    out = ops.flash_decode_attention(q, kc, vc, mask)
    torch.cuda.synchronize()
    assert tfd.launches == before + 1
    assert within(out, ref.decode_attention_ref(q, kc, vc, mask))
    assert out[3].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [1, 3])
@pytest.mark.parametrize("B,S,H,KV,D", [
    (2, 1000, 24, 2, 128),                  # starcoder2-3b heads
    (3, 300, 32, 8, 120),                   # h2o-danube-3-4b's D
    (2, 500, 16, 1, 256),                   # recurrentgemma-9b: D, G = 16
    (2, 260, 8, 2, 32),
    (2, 200, 4, 4, 64),                     # G = 1
])
def test_cuda_flash_decode_kernel_splits_match_plain(cuda, monkeypatch, B,
                                                     S, H, KV, D, n_splits):
    """Several splits of S (the card's own plan, then the plan for an SM
    count that aims at ``n_splits``): row 0 has two wholly masked
    64-slot tiles in the middle, row 1 valid slots only in its first
    tile (every later split all-masked), the last row none (zeros)."""
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn((B, H, D), generator=g, device=cuda).bfloat16()
    kc = torch.randn((B, S, KV, D), generator=g, device=cuda).bfloat16()
    vc = torch.randn((B, S, KV, D), generator=g, device=cuda).bfloat16()
    mask = torch.rand((B, S), generator=g, device=cuda) < 0.7
    mask[0, 64:192] = False
    mask[1, 37:] = False
    mask[-1] = False
    sms = tfd._sm_count(cuda)
    if n_splits > 1:
        groups = B * KV * -(-(H // KV) // tfd.ROW_BLOCK)
        sms = -(-n_splits * groups // tfd.CTAS_PER_SM)
        monkeypatch.setattr(tfd, "_sm_count", lambda _device: sms)
    plan = tfd.split_plan(B, H, KV, S, sms)
    assert plan[0] > 1 and plan[0] * plan[1] * tfd.TILE >= S
    before = tfd.launches
    out = tfd.flash_decode_attention(q, kc, vc, mask)
    torch.cuda.synchronize()
    assert tfd.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert within(out, ref.decode_attention_ref(q, kc, vc, mask))
    assert out[-1].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,KV,D,causal,window", [
    (200, 8, 2, 128, True, None),
    (150, 8, 4, 120, True, 64),             # h2o-danube-3-4b's D
    (90, 4, 4, 64, False, None),
    (130, 8, 2, 32, True, None),            # smoke configs' D
    (200, 8, 1, 112, True, None),           # kimi-k2's D
    (77, 16, 1, 256, True, None),           # recurrentgemma-9b's D, G = 16
    (140, 4, 2, 128, False, 48),            # non-causal, windowed
    (70, 4, 4, 128, True, 33),              # G = 1, windowed
    (300, 8, 2, 64, True, 100),             # window not a tile multiple
])
def test_cuda_flash_attention_kernel_matches_plain(cuda, S, H, KV, D,
                                                   causal, window):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((2, S, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, S, KV, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, S, KV, D), generator=g, device=cuda).bfloat16()
    before = tfa.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert within(out, ref.attention_ref(q, k, v, causal=causal,
                                          window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (70, 150, True, None),                  # keys past the last query
    (150, 70, True, None),                  # queries past the last key
    (150, 70, False, 40),                   # rows 109.. see no key: zeros
    (100, 260, False, 64),
])
def test_cuda_flash_attention_unequal_lengths(cuda, Sq, Sk, causal, window):
    H, KV, D = 8, 2, 128
    g = torch.Generator(device=cuda).manual_seed(Sq * 1000 + Sk)
    q = torch.randn((2, Sq, H, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, Sk, KV, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, Sk, KV, D), generator=g, device=cuda).bfloat16()
    out = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    assert within(out, want)
    if window is not None and Sq > Sk + window:
        assert out[:, Sk + window:].abs().max() == 0


@pytest.mark.cuda
def test_cuda_attention_kernels_refuse_other_head_dims(cuda):
    """A head dim the tensor-core kernels are not built for raises before
    any launch."""
    for D in (100, 264):
        x = torch.zeros((1, 8, 2, D), device=cuda, dtype=torch.bfloat16)
        before = (tfa.launches, tfd.launches)
        with pytest.raises(ValueError, match="head dim"):
            tfa.flash_attention(x, x, x)
        with pytest.raises(ValueError, match="head dim"):
            tfd.flash_decode_attention(x[:, 0], x, x,
                                       torch.ones((1, 8), dtype=torch.bool,
                                                  device=cuda))
        assert (tfa.launches, tfd.launches) == before


# x shapes: the (3, 7, 3840) case of before; 1, 16 and 2048 rows at the
# configs' d_model (starcoder2-3b 3072, 3840, kimi-k2 7168) and at 1000
# (16-byte rows, no power of two); 1001 (no 16-byte rows: the scalar body);
# 40000 (too long for the register-held row: the scalar body)
RMS_SHAPES = ([(3, 7, 3840)]
              + [(n, d) for d in (3072, 3840, 7168, 1000)
                 for n in (1, 16, 2048)]
              + [(16, 1001), (2, 40000)])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_cuda_rms_norm_kernel_matches_plain(cuda, xdt, wdt, shape, offset):
    """``offset`` 1 starts x one element past a 16-byte boundary (a
    contiguous view into a larger buffer): the kernel's scalar body."""
    g = torch.Generator(device=cuda).manual_seed(4)
    n = 1
    for s in shape:
        n *= s
    buf = (torch.randn((n + offset,), generator=g, device=cuda) * 3).to(xdt)
    x = buf[offset:].view(shape)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    w = (torch.randn((shape[-1],), generator=g, device=cuda) * 0.1).to(wdt)
    before = trn.launches
    out = ops.rms_norm(x, w, eps=1e-6)
    torch.cuda.synchronize()
    assert trn.launches == before + 1
    assert out.dtype == xdt and out.shape == x.shape
    assert within(out, ref.rms_norm_ref(x, w, 1e-6))


@pytest.mark.cuda
def test_cuda_ops_never_take_the_plain_version(cuda):
    """``use_kernels=None`` and ``True`` launch on CUDA tensors, and a
    dtype a kernel does not take raises rather than falling back."""
    x = torch.zeros((2, 4, 32), device=cuda, dtype=torch.float16)
    w = torch.zeros((32,), device=cuda, dtype=torch.float16)
    before = trn.launches
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        ops.rms_norm(x, w)
    assert trn.launches == before
    xb, wb = x.bfloat16(), w.bfloat16()
    ops.rms_norm(xb, wb, use_kernels=True)
    ops.rms_norm(xb, wb)
    assert trn.launches == before + 2
    ops.rms_norm(xb, wb, use_kernels=False)
    assert trn.launches == before + 2
    before = tfa.launches
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(x[None], x[None], x[None])
    assert tfa.launches == before


@pytest.mark.cuda
def test_cuda_model_prefill_chunk_goes_through_the_kernel(cuda):
    """A 12-token prompt in chunks of 5 through the smoke model launches
    the chunked-prefill kernel once per layer and chunk with
    ``use_kernels=True`` and never with ``False``; logits agree to bf16
    rounding carried through two layers."""
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.serving import generate
    cfg = configs.get_smoke_config("starcoder2-3b")
    params = model_lib.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    prompt = torch.arange(3, 15, dtype=torch.int32, device=cuda)[None]
    row = torch.tensor([5, 1, 7, 2], dtype=torch.int32, device=cuda)
    logits = {}
    for use_kernels in (True, False):
        cache = transformer.init_paged_cache(cfg, 2, 9, 4, device=cuda)
        before = tcpa.launches
        logits[use_kernels] = generate.prefill_chunked(
            params, cfg, cache, prompt, 1, row, chunk_size=5,
            use_kernels=use_kernels)
        torch.cuda.synchronize()
        assert tcpa.launches - before == (3 * cfg.num_layers
                                          if use_kernels else 0)
        assert int(cache["pos"][1]) == 12
    scale = float(logits[False].abs().max())
    assert float((logits[True] - logits[False]).abs().max()) <= 0.05 * scale


# ---------------------------------------------------------------------------
# CUDA graphs: the continuous engine's executables against eager dispatch
# ---------------------------------------------------------------------------

GC, GBS, GNB, GW, GS = 3, 4, 6, 24, 8      # slots, block, table, ring, prompt


def _smoke_model(cuda, head_dim=None, name="starcoder2-3b"):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    cfg = configs.get_smoke_config(name)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    return cfg, model_lib.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _bits(tree):
    """Every tensor of a cache as raw bits, in order."""
    if isinstance(tree, dict):
        return [b for k in sorted(tree) for b in _bits(tree[k])]
    if isinstance(tree, list):
        return [b for v in tree for b in _bits(v)]
    return [tree.view(torch.int16) if tree.dtype == torch.bfloat16
            else tree]


def _graph_case(name, cfg, cuda):
    """(fn, cache, inputs(step) -> host arrays, static kwargs) of one of
    the engine's executables at a small size, the cache filled with
    random K/V (and recurrent states) and live positions so that every
    step reads real state."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.prefill import build_packed_arrays
    np_rng = np.random.default_rng(7)
    g = torch.Generator(device=cuda).manual_seed(7)
    N = GC * GNB + 1
    if name in ("window ring", "admit ring"):
        cache = transformer.init_slot_cache(cfg, GC, GW, device=cuda)
        cache["pos"].copy_(torch.tensor([5, 9, 2], dtype=torch.int32))
        for s, p in enumerate((5, 9, 2)):
            p = min(p, cache["slot_pos"].shape[1])    # an ssm stack's is 1
            cache["slot_pos"][s, :p] = torch.arange(p, dtype=torch.int32)
    else:
        cache = transformer.init_paged_cache(cfg, GC, N, GBS, device=cuda)
        cache["pos"].copy_(torch.tensor([5, 9, 2], dtype=torch.int32))
    for lc in cache["layers"]:
        for t in lc.values():
            t.copy_(torch.randn(t.shape, generator=g, device=cuda))
    tables = np_rng.permutation(N - 1)[:GC * GNB].reshape(
        GC, GNB).astype(np.int32)

    def toks(*shape):
        return np_rng.integers(2, cfg.vocab_size, shape).astype(np.int32)

    if name == "window paged":
        return (model_lib.decode_steps_paged, cache,
                lambda step: (toks(GC, 1), tables),
                {"num_steps": 2, "use_kernels": True})
    if name == "window ring":
        return (model_lib.decode_steps, cache, lambda step: (toks(GC, 1),),
                {"num_steps": 2})
    if name == "admit paged":
        return (model_lib.prefill_into_paged, cache,
                lambda step: (toks(1, GS), np.array([step % GC], np.int32),
                              tables[(step + 1) % GC]),
                {"max_len": GW})
    if name == "admit ring":
        return (model_lib.prefill_into_slot, cache,
                lambda step: (toks(1, GS), np.array([step % GC], np.int32)),
                {"max_len": GW})
    if name == "cow":
        return (transformer.copy_paged_block, cache,
                lambda step: (np.array([step + 3], np.int32),
                              np.array([2 * step + 10], np.int32)), {})
    # ragged: key (8, 2, 4) with other chunks at every step
    plans = [[(0, 0, 4), (1, 0, 4)], [(0, 4, 3)], [(2, 0, 2), (0, 7, 1)]]

    def ragged(step):
        entries = [(s, ctx, toks(ln), tables[s])
                   for s, ctx, ln in plans[step % len(plans)]]
        return build_packed_arrays((8, 2, 4), entries, pad_slot=GC,
                                   table_width=GNB, trash_block=N - 1)

    return (model_lib.prefill_chunks, cache, ragged,
            {"chunk_pad": 4, "use_kernels": True})


#: (executable, head dim): the smoke model's 32, and 128 for the kernels,
#: whose shared memory at 128 is above 48 KB (a function attribute set
#: at every launch, inside the capture too)
#: the device kernels each engine kernel module's launch runs, once each
KERNEL_EVENTS = {tpfd: ("paged_decode_split_kernel",
                        "paged_decode_combine_kernel"),
                 trcp: ("ragged_prefill_kernel",)}


def _kernel_events(fn):
    """Run ``fn`` under the profiler; the engine kernels' device events by
    name (the profiler names kernels inside a graph too), and fn's value."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    tags = [t for ts in KERNEL_EVENTS.values() for t in ts]
    return {t: sum(t in n for n in names) for t in tags}, out


def _launch_counts():
    return {m: m.launches for m in KERNEL_EVENTS}


def _events_are_launches(events, launches):
    """Each module's device kernels ran once per launch its wrapper
    counted."""
    for m, tags in KERNEL_EVENTS.items():
        for t in tags:
            assert events[t] == launches[m], (t, events[t], launches[m])


GRAPH_CASES = [(n, 32) for n in ("window paged", "window ring",
                                  "admit paged", "admit ring", "cow",
                                  "ragged")] + [("window paged", 128),
                                                ("ragged", 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,head_dim", GRAPH_CASES)
def test_cuda_graphed_executable_equals_eager(cuda, name, head_dim):
    """Each executable warmed (captured), then replayed three times with
    other inputs each time, against the same function run eagerly on a
    copy of the cache: outputs and every cache tensor (pages or rings,
    ``pos``, ``slot_pos``) equal bit for bit after every call, and the
    profiler sees a replay run the kernels that eager dispatch launches
    (each once per launch the wrappers count).  A replay runs no Python,
    so it adds nothing to the wrappers' counts."""
    from repro_torch.serving.generate import GraphExecutable
    cfg, params = _smoke_model(cuda, head_dim)
    fn, cache, inputs, kw = _graph_case(name, cfg, cuda)
    eager = _clone(cache)
    bound = (cache,) if name == "cow" else (params, cfg, cache)
    bound_e = (eager,) if name == "cow" else (params, cfg, eager)
    ex = GraphExecutable(fn, name, cuda)
    ex.warm("k", bound + inputs(0), kw)
    assert list(ex.aot) == ["k"] and ex.capture_s > 0
    for step in range(3):
        args = inputs(step)
        before = _launch_counts()
        graphed, out = _kernel_events(
            lambda: ex.call_aot("k", *bound, *args, **kw))
        assert _launch_counts() == before
        want_ev, want = _kernel_events(
            lambda: fn(*bound_e, *(torch.from_numpy(a).to(cuda)
                                   for a in args), **kw))
        launches = {m: n - before[m] for m, n in _launch_counts().items()}
        _events_are_launches(want_ev, launches)
        assert graphed == want_ev
        assert ex.replays == step + 1
        if want is not None:
            assert torch.equal(out, want)
        for a, b in zip(_bits(cache), _bits(eager)):
            assert torch.equal(a, b)
    if name in ("window paged", "ragged"):
        assert sum(launches.values()) == (cfg.num_layers
                                          * kw.get("num_steps", 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["window ring", "admit ring"])
@pytest.mark.parametrize("model", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_cuda_recurrent_graphed_executable_equals_eager(cuda, model, name):
    """The recurrent families' decode window and stall admission (bf16
    smoke models: the SSD scan, the RG-LRU doubling scan, conv tails and
    states written in place, recurrentgemma's local-attention ring),
    captured, then replayed three times with other inputs, against eager
    calls on a copy of the cache: outputs and every cache tensor equal
    bit for bit after every call."""
    from repro_torch.serving.generate import GraphExecutable
    cfg, params = _smoke_model(cuda, name=model)
    fn, cache, inputs, kw = _graph_case(name, cfg, cuda)
    eager = _clone(cache)
    ex = GraphExecutable(fn, name, cuda)
    ex.warm("k", (params, cfg, cache) + inputs(0), kw)
    assert list(ex.aot) == ["k"]
    for step in range(3):
        args = inputs(step)
        out = ex.call_aot("k", params, cfg, cache, *args, **kw)
        want = fn(params, cfg, eager,
                  *(torch.from_numpy(a).to(cuda) for a in args), **kw)
        torch.cuda.synchronize()
        assert ex.replays == step + 1
        assert torch.equal(out, want)
        for a, b in zip(_bits(cache), _bits(eager)):
            assert torch.equal(a, b)


def _engine_setup(cuda):
    import dataclasses
    from repro_torch.core import datagen, personas
    from repro_torch.core import scheduler as sched
    persona = dataclasses.replace(personas.get_persona("bart"),
                                  batch_size=GC)
    corpus = datagen.generate_corpus(datagen.VARIANCE_MIXES["normal"], 48,
                                     seed=0)
    train, test = datagen.train_test_split(corpus, train_frac=0.5)
    profile = sched.offline_profile(train, persona, epochs=2, device=cuda)
    shared = " ".join(test[0].text.split()[:8])
    texts = [f"{shared} {t.text}" for t in test[:8]]
    return persona, profile, texts


@pytest.mark.cuda
def test_cuda_engine_graphs_rewarm_per_cache_and_match_eager(cuda):
    """Paged stall with the prefix cache, graphed and eager: the same
    tokens, scheduling fields and device kernels (counted by name under
    the profiler; eager's equal to its wrappers' counts).  A second serve
    builds
    a new cache, so the executables drop their graphs and capture again
    against it; with ``persist_prefix_cache`` the cache and its graphs
    live on and the second serve captures nothing."""
    from repro_torch.core import scheduler as sched
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.generate import disable_graphs
    cfg, params = _smoke_model(cuda)
    persona, profile, texts = _engine_setup(cuda)
    caps = [2, 5, 3, 6, 1, 4, 6, 2]

    def engine(**kw):
        return ServingEngine(
            params, cfg, sched.POLICIES["rt-lm"](
                persona, profile.policy_config()), profile,
            mode="continuous", kv="paged", prefill="stall",
            prefix_cache=True, num_slots=GC, kv_block_size=GBS,
            input_bucket=16, max_new_tokens=6, decode_steps=2, eos_id=-1,
            device=cuda, **kw)

    def serve(eng):
        before = _launch_counts()
        events, res = _kernel_events(lambda: eng.serve(
            [Request(text=t, arrival=0.0, task_id=i, max_new_tokens=c)
             for i, (t, c) in enumerate(zip(texts, caps))]))
        res["launches"] = {m: n - before[m]
                           for m, n in _launch_counts().items()}
        res["events"] = events
        res["tokens"] = {t.task.task_id: t.task.out_tokens
                         for t in res["tasks"]}
        return res

    fields = ("tokens", "events", "completion_order",
              "prefill_dispatch_trace", "decode_dispatch_trace",
              "exec_cache_hits", "exec_cache_misses", "cow_copies",
              "cached_tokens_reused")
    with disable_graphs():
        want = serve(engine())
    _events_are_launches(want["events"], want["launches"])
    assert want["launches"][tpfd] > 0 and want["launches"][trcp] > 0
    eng = engine()
    first = serve(eng)
    cache1 = eng.paged_cache.state
    assert eng._window_key in eng._window.aot
    assert eng._admit_key in eng._admit.aot
    assert eng._cow_key in eng._cow.aot
    assert eng._window.replays == first["decode_dispatches"]
    second = serve(eng)
    cache2 = eng.paged_cache.state
    assert cache2 is not cache1
    assert eng._window.aot[eng._window_key].bound[2] is cache2
    assert eng.graph_stats()["warm_s"] > 0
    for res in (first, second):
        for f in fields:
            assert res[f] == want[f], f
    keep = engine(persist_prefix_cache=True)
    serve(keep)
    again = serve(keep)
    assert keep.graph_stats()["capture_s"] == 0.0
    assert keep._window.replays == again["decode_dispatches"] > 0


@pytest.mark.cuda
def test_cuda_capture_with_a_host_read_raises(cuda):
    """No fallback: a function that reads a device value on the host
    cannot be captured, and ``warm`` raises and keeps no graph."""
    from repro_torch.serving.generate import GraphExecutable

    def host_read(x):
        return x * int(x.sum())

    ex = GraphExecutable(host_read, "host-read", cuda)
    with pytest.raises(RuntimeError):
        ex.warm("k", (torch.ones(3, device=cuda),))
    assert ex.aot == {}


# ---------------------------------------------------------------------------
# observability: the card's traced stream is the CPU's
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["stall", "chunked-prefix"])
def test_cuda_traced_serve_emits_the_cpu_stream(cuda, row):
    """One row served traced on the CPU, and on the card eagerly and
    graphed (one m_theta for all three, so ``u`` is the same): the event
    stream less its wall fields, the counters, the SLO counts, the
    calibration ledger and the health vector are the CPU's.  Executable-
    cache events come from the shape keys, not from what was captured.
    The graphed serve's tokens are the eager one's, and an untraced graphed
    serve has the traced one's schedule."""
    from repro_torch.core import scheduler as sched
    from repro_torch.obs import Observability, SLOSpec
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.generate import disable_graphs
    cfg, params = _smoke_model(cuda)
    params_cpu = _to(params, "cpu")
    persona, profile, texts = _engine_setup(cuda)
    caps = [2, 5, 3, 6, 1, 4, 6, 2]
    classes = ["interactive", "batch"] * 4
    kw = (dict(prefill="stall", num_slots=GC, kv_num_blocks=14)
          if row == "stall" else
          dict(prefill="chunked", chunk_size=5, prefix_cache=True,
               num_slots=GC))

    def serve(device, p, traced=True):
        obs = (Observability(slo={"interactive": SLOSpec(),
                                  "batch": SLOSpec(ttft_s=-1.0, itl_s=-1.0,
                                                   e2e_s=-1.0,
                                                   queue_wait_s=-1.0)},
                             calibration=True, snapshot_every_steps=2)
               if traced else None)
        eng = ServingEngine(
            p, cfg, sched.POLICIES["fifo"](persona, profile.policy_config()),
            profile, mode="continuous", kv="paged", kv_block_size=GBS,
            input_bucket=16, max_new_tokens=6, decode_steps=2, eos_id=-1,
            device=device, obs=obs, **kw)
        res = eng.serve([Request(text=t, arrival=0.0, task_id=i,
                                 max_new_tokens=c, traffic_class=k)
                         for i, (t, c, k) in enumerate(zip(texts, caps,
                                                           classes))])
        assert res["fallback_events"] == 0
        return res, obs

    def view(obs):
        return (obs.trace.parity_events(), obs.metrics.counters(),
                obs.slo.parity_counters(), obs.calibration.parity(),
                [{k: h[k] for k in ("step", "queue_depth", "active",
                                    "kv_util", "drift", "calibration_count")}
                 for h in obs.health_trace])

    _, want = serve("cpu", params_cpu)
    with disable_graphs():
        eager, eobs = serve(cuda, params)
    graphed, gobs = serve(cuda, params)
    plain, _ = serve(cuda, params, traced=False)
    assert view(eobs) == view(want) and view(gobs) == view(want)
    assert {e.kind for e in gobs.trace.events} >= {"admit", "token",
                                                   "decode_window"}

    def tokens(res):
        return {t.task.task_id: t.task.out_tokens for t in res["tasks"]}

    assert tokens(graphed) == tokens(eager) == tokens(plain)
    for f in ("completion_order", "prefill_dispatch_trace",
              "decode_dispatch_trace", "exec_cache_hits",
              "exec_cache_misses", "budget_trace", "cow_copies"):
        assert graphed[f] == eager[f] == plain[f], f


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
