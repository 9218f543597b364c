"""PyTorch port: the CUDA kernels against their plain versions, on the card.

Needs a CUDA card (and ``nvcc`` to build the kernels); every test carries
the ``cuda`` marker and skips with a reason elsewhere.  The file imports
only ``torch`` and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

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
    B, H, KV = 4, 24, 2
    N = B * nb + 1
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, H, D), generator=g, device=cuda).bfloat16()
    kp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    vp = torch.randn((N, bs, KV, D), generator=g, device=cuda).bfloat16()
    tab = torch.randperm(N - 1, generator=g, device=cuda)[:B * nb].view(
        B, nb).int()
    lens = torch.tensor([0, 1, 37, nb * bs], dtype=torch.int32, device=cuda)
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
    for C in (3, 16)]


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
