"""PyTorch port: the design of the two tensor-core prefill kernels, checked
on the CPU.

The CUDA kernels (csrc/ragged_chunked_prefill.cu and
csrc/chunked_prefill_attention.cu over csrc/prefill_attn.cuh) run only on
the card (tests/test_torch_cuda.py).  What their design rests on is plain
arithmetic and host code, held here:

  * their body, modelled in ``ref.ragged_prefill_tiles`` and
    ``ref.chunked_prefill_tiles`` (16-row tiles of the t-major query rows,
    64-position key tiles that span pages, tiles wholly at
    ``t >= chunk_len`` skipped and zero), against the port's oracles
    (``ref.ragged_chunked_prefill_ref``, ``ref.chunked_prefill_attention_ref``)
    and the JAX Pallas kernels in interpret mode, for page sizes that
    divide the tile and one that does not (48), G 1 and 12, contexts 0, 1
    and 70, chunk lengths 1, below and at T_pad, and a padding chunk whose
    table is all the trash page;
  * table entries past the last position a chunk's queries see are never
    read (page ids far outside the pool there change nothing);
  * the fused scatter's rule: token t is stored by the one CTA whose rows
    hold row t * G;
  * the wrappers' host path with the launch stubbed: head dims the kernels
    do not take, and tensors off a 16-byte boundary, are refused before
    any launch.

Tolerances as in tests/test_torch_paged_decode_design.py: 2e-6 against the
port's oracles (the same float32 sums in another order), 2e-5 against the
Pallas kernels (another online-softmax order).  Pages are bit-equal.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import chunked_prefill_attention as jcpa  # noqa: E402
from repro.kernels import ragged_chunked_prefill as jrcp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import chunked_prefill_attention as tcpa  # noqa: E402
from repro_torch.kernels import ragged_chunked_prefill as trcp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ORACLE_TOL = dict(atol=2e-6, rtol=2e-6)
PALLAS_TOL = dict(atol=2e-5, rtol=2e-5)
D = 16
T_PAD = 16
#: G -> (H, KV)
HEADS = {1: (2, 2), 12: (24, 2)}
#: (ctx_len, chunk_len): a full first chunk, a one-token chunk at context
#: 1, a short chunk past a context that is no multiple of the 64-position
#: tile, a full chunk straddling a tile, and a chunk_len == 0 padding chunk
CHUNKS = [(0, T_PAD), (1, 1), (70, 9), (50, T_PAD), (0, 0)]


def _ragged_case(bs: int, G: int, seed: int = 0):
    """CHUNKS over permuted tables of 80 positions; the padding chunk's
    table is all the trash page (the last one, which no chunk owns)."""
    H, KV = HEADS[G]
    C = len(CHUNKS)
    nb = -(-80 // bs)
    N = C * nb + 1
    rng = np.random.default_rng(seed * 131 + bs + G)
    q = rng.standard_normal((C, T_PAD, H, D), np.float32)
    kn = rng.standard_normal((C, T_PAD, KV, D), np.float32)
    vn = rng.standard_normal((C, T_PAD, KV, D), np.float32)
    kp = rng.standard_normal((N, bs, KV, D), np.float32)
    vp = rng.standard_normal((N, bs, KV, D), np.float32)
    tables = rng.permutation(N - 1)[:C * nb].reshape(C, nb).astype(np.int32)
    meta = np.zeros((C, 4), np.int32)
    off = 0
    for c, (ctx, ln) in enumerate(CHUNKS):
        meta[c] = (c, ctx, ln, off)
        off += ln
        if ln == 0:
            tables[c] = N - 1
    return q, kn, vn, kp, vp, tables, meta


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _dead_rows(out_c, clen, G):
    """Rows of one chunk's (T, H, D) output in 16-row t-major tiles wholly
    at t >= clen, per KV group."""
    T, H, _ = out_c.shape
    rows = out_c.reshape(T, H // G, G, D).transpose(0, 1).reshape(
        H // G, T * G, D)
    return rows[:, -(-clen * G // tref.PREFILL_WARP_ROWS)
                * tref.PREFILL_WARP_ROWS:]


def _trash_past(tables, last_pos, bs):
    """Table entries past the page of each row's last visible position set
    to page ids far outside the pool."""
    t = tables.copy()
    for c, last in enumerate(last_pos):
        if last >= 0:
            t[c, last // bs + 1:] = 10 ** 6
    return t


# ---------------------------------------------------------------------------
# the fused ragged prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", sorted(HEADS))
@pytest.mark.parametrize("bs", [16, 48])
def test_ragged_tiles_match_the_oracle(bs, G):
    q, kn, vn, kp, vp, tables, meta = _torch(*_ragged_case(bs, G))
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    got = tref.ragged_prefill_tiles(q, kn, vn, k1, v1, tables, meta)
    want = tref.ragged_chunked_prefill_ref(q, kn, vn, k2, v2, tables, meta)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    N = kp.shape[0]
    assert torch.equal(k1[N - 1], kp[N - 1])
    assert torch.isfinite(got).all()
    for c, (_, ln) in enumerate(CHUNKS):
        np.testing.assert_allclose(got[c, :ln].numpy(), want[c, :ln].numpy(),
                                   **ORACLE_TOL)
        assert not _dead_rows(got[c], ln, G).any()
    assert not got[-1].any()                  # the padding chunk: zeros


@pytest.mark.parametrize("G", sorted(HEADS))
@pytest.mark.parametrize("bs", [16, 48])
def test_ragged_tiles_match_pallas(bs, G):
    q, kn, vn, kp, vp, tables, meta = _ragged_case(bs, G, seed=1)
    out_j, nk_j, nv_j = jrcp.ragged_chunked_prefill(
        *(jnp.asarray(a) for a in (q, kn, vn, kp, vp, tables, meta)),
        interpret=True)
    qt, knt, vnt, k1, v1, tt, mt = _torch(q, kn, vn, kp, vp, tables, meta)
    got = tref.ragged_prefill_tiles(qt, knt, vnt, k1, v1, tt, mt)
    np.testing.assert_array_equal(k1.numpy(), np.asarray(nk_j))
    np.testing.assert_array_equal(v1.numpy(), np.asarray(nv_j))
    for c, (_, ln) in enumerate(CHUNKS):
        np.testing.assert_allclose(got[c, :ln].numpy(),
                                   np.asarray(out_j)[c, :ln], **PALLAS_TOL)


@pytest.mark.parametrize("G", sorted(HEADS))
@pytest.mark.parametrize("bs", [16, 48])
def test_ragged_tiles_never_read_entries_past_the_last_position(bs, G):
    """Neither the scatter nor the attention reads a table entry past the
    page of ``ctx_len + chunk_len - 1``."""
    case = _ragged_case(bs, G, seed=2)
    tables, meta = case[5], case[6]
    trashed = _trash_past(tables, meta[:, 1] + meta[:, 2] - 1, bs)
    trashed[-1] = 10 ** 6                     # the padding chunk: all
    outs, pools = [], []
    for tab in (tables, trashed):
        q, kn, vn, kp, vp, tt, mt = _torch(*case[:5], tab, meta)
        outs.append(tref.ragged_prefill_tiles(q, kn, vn, kp, vp, tt, mt))
        pools.append((kp, vp))
    np.testing.assert_array_equal(outs[1].numpy(), outs[0].numpy())
    for a, b in zip(*pools):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cta_rows", [16, 32, 64])
@pytest.mark.parametrize("T,G", [(16, 1), (32, 12), (32, 16), (9, 7),
                                 (32, 24), (1, 12)])
def test_scatter_has_one_writer_per_token(T, G, cta_rows):
    """Every token of a chunk is stored by exactly one CTA, the one whose
    rows hold row t * G; CTAs whose rows hold no such row store none."""
    writer = tref.prefill_writer_tiles(T, G, cta_rows)
    t = torch.arange(T)
    assert torch.equal(writer, t * G // cta_rows)
    n_ctas = -(-T * G // cta_rows)
    counts = torch.bincount(writer, minlength=n_ctas)
    assert int(counts.sum()) == T and len(counts) == n_ctas
    assert all(int(counts[i]) == len({x for x in range(T)
                                      if x * G // cta_rows == i})
               for i in range(n_ctas))


@pytest.mark.parametrize("name,value", [
    ("kTileKeys", tref.PREFILL_TILE_KEYS),
    ("kWarpRows", tref.PREFILL_WARP_ROWS),
    ("kCtaRows", tref.PREFILL_CTA_ROWS)])
def test_tile_model_constants_are_the_kernels(name, value):
    """The tile model's sizes are the ones the prefill kernels are built
    with: csrc/prefill_attn.cuh's constants, evaluated from its source."""
    src = (_build.CSRC / "prefill_attn.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    env = {}
    for k, expr in consts.items():
        # a literal or a product of the constants declared above it
        env[k] = eval(expr, {"__builtins__": {}}, env)
    assert env[name] == value


def test_ragged_dead_tiles_and_padding_chunk_read_nothing():
    """A chunk_len == 0 chunk and the tiles wholly at t >= chunk_len never
    call the position lookup: the body returns zeros before reading."""
    q = torch.randn((T_PAD, 24, D))

    def no_read(p):
        raise AssertionError("a dead tile read a position")

    out = tref._prefill_tiles(q, 2, 0, lambda t: t, no_read)
    assert not out.any()
    reads = []

    def rows(p):
        reads.append(p.clone())
        return torch.randn((len(p), 2, D)), torch.randn((len(p), 2, D))

    out = tref._prefill_tiles(q, 2, 1, lambda t: t.clamp(max=0), rows)
    # G = 12: one live 16-row tile of the 192 rows a group (the model
    # takes both groups at once), which reads one position
    assert [r.tolist() for r in reads] == [[0]]
    assert not out[2:].any() and not out[1, 4:12].any()


# ---------------------------------------------------------------------------
# the single-chunk prefill
# ---------------------------------------------------------------------------


def _chunked_case(bs: int, G: int, T: int, seed: int = 0):
    """Four sequences at contexts 0, 1, 70 and 33 over permuted tables of
    112 positions (the pages already hold the chunk's own K/V)."""
    H, KV = HEADS[G]
    ctxs = np.asarray([0, 1, 70, 33], np.int32)
    B = len(ctxs)
    nb = -(-112 // bs)
    N = B * nb + 2
    rng = np.random.default_rng(seed * 71 + bs + G + T)
    q = rng.standard_normal((B, T, H, D), np.float32)
    kp = rng.standard_normal((N, bs, KV, D), np.float32)
    vp = rng.standard_normal((N, bs, KV, D), np.float32)
    tables = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    return q, kp, vp, tables, ctxs


@pytest.mark.parametrize("T", [1, 9, 32])
@pytest.mark.parametrize("G", sorted(HEADS))
@pytest.mark.parametrize("bs", [16, 48])
def test_chunked_tiles_match_the_oracle(bs, G, T):
    q, kp, vp, tables, ctxs = _torch(*_chunked_case(bs, G, T))
    got = tref.chunked_prefill_tiles(q, kp, vp, tables, ctxs)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(),
        tref.chunked_prefill_attention_ref(q, kp, vp, tables, ctxs).numpy(),
        **ORACLE_TOL)


@pytest.mark.parametrize("G", sorted(HEADS))
@pytest.mark.parametrize("bs", [16, 48])
def test_chunked_tiles_match_pallas(bs, G):
    case = _chunked_case(bs, G, 9, seed=1)
    pallas = np.asarray(jcpa.chunked_prefill_attention(
        *(jnp.asarray(a) for a in case), interpret=True))
    got = tref.chunked_prefill_tiles(*_torch(*case))
    np.testing.assert_allclose(got.numpy(), pallas, **PALLAS_TOL)


@pytest.mark.parametrize("bs", [16, 48])
def test_chunked_tiles_never_read_entries_past_the_last_position(bs):
    q, kp, vp, tables, ctxs = _chunked_case(bs, 12, 9, seed=2)
    trashed = _trash_past(tables, ctxs + 9 - 1, bs)
    assert (trashed != tables).any()
    want = tref.chunked_prefill_tiles(*_torch(q, kp, vp, tables, ctxs))
    got = tref.chunked_prefill_tiles(*_torch(q, kp, vp, trashed, ctxs))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_first_chunk_query_zero_sees_one_key():
    """ctx 0: query 0 sees position 0 only, so its output is that
    position's value in every head of the group."""
    q, kp, vp, tables, ctxs = _torch(*_chunked_case(16, 12, 9, seed=3))
    out = tref.chunked_prefill_tiles(q, kp, vp, tables, ctxs)
    first = vp[int(tables[0, 0]), 0]                      # (KV, D)
    np.testing.assert_allclose(
        out[0, 0].numpy(),
        torch.repeat_interleave(first, 12, dim=0).numpy(), **ORACLE_TOL)


# ---------------------------------------------------------------------------
# the wrappers' host path (the launch itself stubbed: no card here)
# ---------------------------------------------------------------------------


def _stub_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "on_card", lambda x: True)
    monkeypatch.setattr(_build, "launch",
                        lambda module, symbol, argtypes, *args, device:
                        calls.append((module.NAME, symbol, args)))
    return calls


def _ragged_args(Dq, C=2, T=4, H=4, KV=2, bs=16):
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    return (z(C, T, H, Dq), z(C, T, KV, Dq), z(C, T, KV, Dq),
            z(5, bs, KV, Dq), z(5, bs, KV, Dq),
            torch.zeros((C, 2), dtype=torch.int32),
            torch.tensor([[0, 0, T, 0], [1, 0, 0, T]][:C], dtype=torch.int32))


def _chunked_args(Dq, B=2, T=4, H=4, KV=2, bs=16):
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    return (z(B, T, H, Dq), z(5, bs, KV, Dq), z(5, bs, KV, Dq),
            torch.zeros((B, 2), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.int32))


@pytest.mark.parametrize("Dq", [32, 64, 112, 120, 128, 256])
def test_wrappers_launch_the_head_dims_the_kernels_take(monkeypatch, Dq):
    calls = _stub_card(monkeypatch)
    out = trcp.ragged_chunked_prefill(*_ragged_args(Dq))
    assert out.shape == (2, 4, 4, Dq) and out.dtype == torch.bfloat16
    out = tcpa.chunked_prefill_attention(*_chunked_args(Dq))
    assert out.shape == (2, 4, 4, Dq)
    assert [c[:2] for c in calls] == [
        ("ragged_chunked_prefill", "rtlm_ragged_chunked_prefill"),
        ("chunked_prefill_attention", "rtlm_chunked_prefill_attention")]
    # ..., C or B, T, H, KV, D, bs, nb, scale
    assert calls[0][2][8:15] == (2, 4, 4, 2, Dq, 16, 2)
    assert calls[1][2][6:13] == (2, 4, 4, 2, Dq, 16, 2)
    assert calls[0][2][15] == pytest.approx(Dq ** -0.5)


@pytest.mark.parametrize("Dq", [0, 100, 124, 264])
def test_wrappers_refuse_head_dims_before_launch(monkeypatch, Dq):
    calls = _stub_card(monkeypatch)
    with pytest.raises(ValueError, match="head dim"):
        trcp.ragged_chunked_prefill(*_ragged_args(Dq))
    with pytest.raises(ValueError, match="head dim"):
        tcpa.chunked_prefill_attention(*_chunked_args(Dq))
    assert calls == []


def test_wrappers_refuse_tensors_off_16_bytes_before_launch(monkeypatch):
    """A contiguous view one element into a buffer: the kernels' 16-byte
    copies cannot take it."""
    calls = _stub_card(monkeypatch)
    args = list(_ragged_args(64))
    buf = torch.zeros(args[0].numel() + 1, dtype=torch.bfloat16)
    args[0] = buf[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="16-byte"):
        trcp.ragged_chunked_prefill(*args)
    cargs = list(_chunked_args(64))
    buf = torch.zeros(cargs[1].numel() + 1, dtype=torch.bfloat16)
    cargs[1] = buf[1:].view(cargs[1].shape)
    with pytest.raises(ValueError, match="16-byte"):
        tcpa.chunked_prefill_attention(*cargs)
    assert calls == []
