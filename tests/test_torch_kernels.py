"""PyTorch port: the kernels' plain versions against the Pallas kernels.

The Pallas kernels run in interpret mode on the CPU, as the JAX package's
own kernel tests run them, over the same sweeps (tests/test_kernels.py:
paged decode, the ``seq_len == 0`` row, the fused ragged prefill and its
padding chunk).  Pages must be bit-equal; outputs agree within the
reference tests' own tolerances.  The CUDA kernels themselves need a card:
they are tested in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_decode_attention as jpfd  # noqa: E402
from repro.kernels import ragged_chunked_prefill as jrcp  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpfd  # noqa: E402
from repro_torch.kernels import ragged_chunked_prefill as trcp  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    # the reference kernel tests' tolerances: bf16 outputs round at
    # 2^-8 relative, float32 sums differ only in order
    return (dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def _pair(a: np.ndarray, dtype: str):
    """The same float32 numpy data as a jnp and a torch array of
    ``dtype`` (both round to nearest even, so the bits agree)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KV,D,block_size,nb", [
    (2, 4, 2, 32, 16, 4),
    (1, 8, 1, 64, 32, 3),
    (3, 4, 4, 16, 64, 2),
    (2, 8, 2, 128, 16, 5),
])
def test_paged_decode_plain_vs_pallas(B, H, KV, D, block_size, nb, dtype):
    N = B * nb + 3
    rng = np.random.default_rng(B * 131 + block_size)
    q_j, q_t = _pair(rng.standard_normal((B, H, D), np.float32), dtype)
    kp = rng.standard_normal((N, block_size, KV, D), np.float32)
    vp = rng.standard_normal((N, block_size, KV, D), np.float32)
    kp_j, kp_t = _pair(kp, dtype)
    vp_j, vp_t = _pair(vp, dtype)
    tables = np.stack([rng.permutation(N)[:nb]
                       for _ in range(B)]).astype(np.int32)
    lens = rng.integers(1, nb * block_size + 1, (B,)).astype(np.int32)
    want = jpfd.paged_flash_decode_attention(
        q_j, kp_j, vp_j, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True)
    before = tpfd.launches
    got = tpfd.paged_flash_decode_attention(
        q_t, kp_t, vp_t, torch.from_numpy(tables), torch.from_numpy(lens))
    assert tpfd.launches == before           # CPU: the plain version
    assert got.shape == (B, H, D) and got.dtype == q_t.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_paged_decode_empty_row_returns_zeros():
    B, H, KV, D, bs, nb = 2, 4, 2, 32, 16, 3
    N = B * nb
    rng = np.random.default_rng(6)
    q_j, q_t = _pair(rng.standard_normal((B, H, D), np.float32), "float32")
    kp_j, kp_t = _pair(rng.standard_normal((N, bs, KV, D), np.float32),
                       "float32")
    vp_j, vp_t = _pair(rng.standard_normal((N, bs, KV, D), np.float32),
                       "float32")
    tables = np.arange(N, dtype=np.int32).reshape(B, nb)
    lens = np.asarray([0, 11], np.int32)
    want = jpfd.paged_flash_decode_attention(
        q_j, kp_j, vp_j, jnp.asarray(tables), jnp.asarray(lens),
        interpret=True)
    got = tpfd.paged_flash_decode_attention(
        q_t, kp_t, vp_t, torch.from_numpy(tables), torch.from_numpy(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.zeros((H, D)))
    np.testing.assert_array_equal(_np(want)[0], np.zeros((H, D)))
    np.testing.assert_allclose(got[1].numpy(), _np(want)[1],
                               atol=2e-5, rtol=2e-5)


def _ragged_case(lens, ctxs, *, H=4, KV=2, D=32, bs=16, seed=0,
                 dtype="float32"):
    """A fused ragged-prefill case (the reference tests' builder), from
    numpy: C chunks with their own permuted tables plus spare pages."""
    C = len(lens)
    Tp = 1
    while Tp < max(lens):
        Tp *= 2
    nb = max(-(-(c + l) // bs) for c, l in zip(ctxs, lens)) + 1
    N = C * nb + 3
    rng = np.random.default_rng(seed * 7 + C)
    arrays = [rng.standard_normal(s, np.float32) for s in
              ((C, Tp, H, D), (C, Tp, KV, D), (C, Tp, KV, D),
               (N, bs, KV, D), (N, bs, KV, D))]
    tables = rng.permutation(N)[:C * nb].reshape(C, nb).astype(np.int32)
    off, meta = 0, []
    for c, (ln, ctx) in enumerate(zip(lens, ctxs)):
        meta.append([c, ctx, ln, off])
        off += ln
    pairs = [_pair(a, dtype) for a in arrays]
    return pairs, tables, np.asarray(meta, np.int32)


def _run_both(pairs, tables, meta):
    (q_j, q_t), (kn_j, kn_t), (vn_j, vn_t), (kp_j, kp_t), (vp_j, vp_t) = \
        pairs
    out_j, nk_j, nv_j = jrcp.ragged_chunked_prefill(
        q_j, kn_j, vn_j, kp_j, vp_j, jnp.asarray(tables), jnp.asarray(meta),
        interpret=True)
    kp_t, vp_t = kp_t.clone(), vp_t.clone()
    out_t = trcp.ragged_chunked_prefill(
        q_t, kn_t, vn_t, kp_t, vp_t, torch.from_numpy(tables),
        torch.from_numpy(meta))
    return (out_j, nk_j, nv_j), (out_t, kp_t, vp_t)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32).numpy()
    return np.asarray(x).view(np.int16 if x.dtype == jnp.bfloat16
                              else np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens,ctxs", [
    ([1, 1, 1], [0, 5, 31]),
    ([10, 24], [13, 7]),
    ([16, 8, 4], [0, 0, 0]),
    ([32], [9]),
    ([16, 64, 128, 64, 16], [3, 0, 40, 16, 128]),
])
def test_ragged_prefill_plain_vs_pallas(lens, ctxs, dtype):
    pairs, tables, meta = _ragged_case(lens, ctxs, dtype=dtype)
    (out_j, nk_j, nv_j), (out_t, nk_t, nv_t) = _run_both(pairs, tables, meta)
    np.testing.assert_array_equal(_bits(nk_t), _bits(nk_j))
    np.testing.assert_array_equal(_bits(nv_t), _bits(nv_j))
    assert out_t.shape == pairs[0][1].shape
    for c, ln in enumerate(lens):
        np.testing.assert_allclose(_np(out_t)[c, :ln], _np(out_j)[c, :ln],
                                   **_tol(dtype))


def test_ragged_padding_chunk_writes_nothing():
    lens, ctxs = [8, 4], [0, 16]
    pairs, tables, meta = _ragged_case(lens, ctxs, seed=5)
    N = pairs[3][0].shape[0]
    spare = sorted(set(range(N)) - set(tables.ravel().tolist()))[0]
    tables_pad = np.concatenate([tables, np.full_like(tables[:1], spare)])
    meta_pad = np.concatenate([meta, np.asarray([[2, 0, 0, 12]], np.int32)])
    pairs_pad = [(jnp.concatenate([a, a[:1]]), torch.cat([b, b[:1]]))
                 for a, b in pairs[:3]] + list(pairs[3:])
    (oj, kj, vj), (ot, kt, vt) = _run_both(pairs_pad, tables_pad, meta_pad)
    (_, kj0, vj0), (ot0, kt0, vt0) = _run_both(pairs, tables, meta)
    for a, b in ((kt, kj), (vt, vj), (kt, kt0), (vt, vt0), (kj, kj0)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(kt[spare]),
                                  _bits(pairs[3][1][spare]))
    for c, ln in enumerate(lens):
        np.testing.assert_array_equal(ot[c, :ln].numpy(),
                                      ot0[c, :ln].numpy())
        np.testing.assert_allclose(ot[c, :ln].numpy(), _np(oj)[c, :ln],
                                   atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    q = torch.empty((2, 4, 32), device="meta")
    pages = torch.empty((6, 16, 2, 32), device="meta")
    tab = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpfd.paged_flash_decode_attention(q, pages, pages, tab, tab[:, 0])
    with pytest.raises(ValueError, match="no kernel"):
        trcp.ragged_chunked_prefill(q[None], q[None], q[None], pages, pages,
                                    tab, tab)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["paged_decode_attention"])
    assert not (tmp_path / "build").exists()


def test_library_path_keyed_by_sources():
    a = _build.library_path("paged_decode_attention")
    b = _build.library_path("ragged_chunked_prefill")
    assert a != b and a.parent == b.parent == _build.BUILD_DIR
    assert a == _build.library_path("paged_decode_attention")


def test_check_tensors_refuses_what_a_kernel_cannot_take():
    a = torch.zeros((2, 3), dtype=torch.bfloat16)
    _build.check_tensors((("a", a, torch.bfloat16),
                          ("b", a.float(), (torch.bfloat16, torch.float32))))
    with pytest.raises(TypeError, match="b: torch.float32"):
        _build.check_tensors((("a", a, torch.bfloat16),
                              ("b", a.float(), torch.bfloat16)))
    with pytest.raises(ValueError, match="not contiguous"):
        _build.check_tensors((("a", a.t(), torch.bfloat16),))
    with pytest.raises(ValueError, match="b on meta"):
        _build.check_tensors((("a", a, torch.bfloat16),
                              ("b", a.to("meta"), torch.bfloat16)))


def test_launch_counts_only_launches_that_return_no_error(monkeypatch):
    """``_build.launch`` passes the stream last, raises on a CUDA error
    code with the library's message, and counts only a clean launch."""
    calls = []

    class Symbol:                 # a ctypes function: settable argtypes
        def __call__(self, *args):
            calls.append(args)
            return args[0]

    class Lib:
        rtlm_fake = Symbol()

        @staticmethod
        def rtlm_error_string(rc):
            return b"an error"

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "current_stream", lambda device: 77)
    monkeypatch.setattr(_build, "_symbols", {})
    monkeypatch.setattr(tpfd, "launches", 5)
    _build.launch(tpfd, "rtlm_fake", [_build.I], 0, device="cuda")
    assert calls[-1] == (0, 77) and tpfd.launches == 6
    assert Lib.rtlm_fake.argtypes == [_build.I, _build.P]
    with pytest.raises(RuntimeError, match="CUDA error 3 \\(an error\\)"):
        _build.launch(tpfd, "rtlm_fake", [_build.I], 3, device="cuda")
    assert tpfd.launches == 6


def test_launch_types_each_symbol_once(monkeypatch):
    """A symbol's ctypes function is looked up and typed on its first
    launch only; later launches reuse it (the decode loop is host-bound)."""
    loads = []

    class Symbol:
        def __call__(self, *args):
            return 0

    class Lib:
        rtlm_fake = Symbol()

    monkeypatch.setattr(_build, "load",
                        lambda name: loads.append(name) or Lib())
    monkeypatch.setattr(_build, "current_stream", lambda device: 0)
    monkeypatch.setattr(_build, "_symbols", {})
    monkeypatch.setattr(tpfd, "launches", 0)
    for _ in range(3):
        _build.launch(tpfd, "rtlm_fake", [_build.I], 0, device="cuda")
    assert loads == ["paged_decode_attention"] and tpfd.launches == 3
    assert Lib.rtlm_fake.argtypes == [_build.I, _build.P]
