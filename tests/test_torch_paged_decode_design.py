"""PyTorch port: the design of the split-K paged decode kernel, checked on
the CPU.

The CUDA kernel (csrc/paged_decode_attention.cu over csrc/split_decode.cuh)
runs only on the card (tests/test_torch_cuda.py).  What its design rests
on is plain arithmetic and host code, held here:

  * its two passes, modelled in ``ref.paged_decode_split_partials`` and
    ``ref.combine_split_partials``, against the port's oracle
    (``ref.paged_decode_attention_ref``) and the JAX Pallas kernel in
    interpret mode, for page sizes that divide the 64-slot tile and one
    that does not (48), splits wholly past ``seq_len``, ``seq_len`` 0 and
    1, and permuted tables whose entries past the live pages are never
    read;
  * the host's split plan, shared with the contiguous decode kernel
    (``flash_decode_attention.split_plan`` over ``nb * bs`` positions), at
    chip_smoke's and the engine's shape and at its edges;
  * the wrapper's host path: the plan from shapes alone, ``seq_lens``
    never read on the host, head dims the kernel does not take refused
    before any launch.

Tolerances are the float32 ones of tests/test_torch_attention_design.py:
2e-6 against the port's oracle (the same float32 sums in another order),
2e-5 against the Pallas kernel (another online-softmax order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_decode_attention as jpfd  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_decode_attention as tfd  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpfd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ORACLE_TOL = dict(atol=2e-6, rtol=2e-6)
PALLAS_TOL = dict(atol=2e-5, rtol=2e-5)
H, KV, D = 4, 2, 16

#: page size -> table width: 5 or 6 tiles of 64 positions each
WIDTHS = {8: 40, 16: 20, 48: 7, 64: 5}


def _paged_case(bs: int, seed: int = 0):
    """B = 6 sequences over nb * bs positions in permuted tables: lengths
    0, 1, 70 (straddles a tile and a page), one tile exactly (64), one
    page past a tile boundary, and the whole table."""
    nb = WIDTHS[bs]
    L = nb * bs
    lens = np.asarray([0, 1, 70, 64, min(L, 128 + bs), L], np.int32)
    B = len(lens)
    N = B * nb + 3
    rng = np.random.default_rng(seed * 97 + bs)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((N, bs, KV, D), np.float32)
    vp = rng.standard_normal((N, bs, KV, D), np.float32)
    tables = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    return q, kp, vp, tables, lens


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _plan_splits(nb: int, bs: int, B: int) -> int:
    """The kernel's n_splits for this shape on a 132-SM card."""
    return tfd.split_plan(B, H, KV, nb * bs, 132)[0]


# ---------------------------------------------------------------------------
# the two passes against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_splits", [1, 2, 5])
@pytest.mark.parametrize("bs", sorted(WIDTHS))
def test_paged_split_partials_combine_to_the_oracle(bs, n_splits):
    q, kp, vp, tables, lens = _torch(*_paged_case(bs))
    m, l, acc = tref.paged_decode_split_partials(q, kp, vp, tables, lens,
                                                 n_splits)
    B = q.shape[0]
    assert m.shape == l.shape == (B, H, n_splits)
    assert acc.shape == (B, H, n_splits, D)
    got = tref.combine_split_partials(m, l, acc)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(),
        tref.paged_decode_attention_ref(q, kp, vp, tables, lens).numpy(),
        **ORACLE_TOL)
    np.testing.assert_array_equal(got[0].numpy(), np.zeros((H, D)))


@pytest.mark.parametrize("bs", sorted(WIDTHS))
def test_paged_split_partials_match_pallas(bs):
    """At the kernel's own plan (about two CTAs an SM: one split per
    64-slot tile here), every row, the ``seq_len == 0`` one included (the
    Pallas kernel returns zeros there too)."""
    q, kp, vp, tables, lens = _paged_case(bs)
    n_splits = _plan_splits(WIDTHS[bs], bs, len(lens))
    assert n_splits == -(-WIDTHS[bs] * bs // tfd.TILE)
    got = tref.combine_split_partials(*tref.paged_decode_split_partials(
        *_torch(q, kp, vp, tables, lens), n_splits))
    pallas = np.asarray(jpfd.paged_flash_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True))
    np.testing.assert_array_equal(pallas[0], np.zeros((H, D)))
    np.testing.assert_allclose(got.numpy(), pallas, **PALLAS_TOL)


@pytest.mark.parametrize("bs", [16, 48])
def test_paged_split_partials_past_seq_len_are_empty(bs):
    """A range wholly past ``seq_len`` gives m = NEG_INF, l = 0, acc = 0;
    a range holding a live position a finite m and l > 0."""
    q, kp, vp, tables, lens = _torch(*_paged_case(bs, seed=1))
    n_splits = -(-WIDTHS[bs] * bs // 64)        # one tile a range
    m, l, acc = tref.paged_decode_split_partials(q, kp, vp, tables, lens,
                                                 n_splits)
    for b, ln in enumerate(lens.tolist()):
        for i in range(n_splits):
            if i * 64 >= ln:
                assert (m[b, :, i] == tref.NEG_INF).all()
                assert (l[b, :, i] == 0).all()
                assert (acc[b, :, i] == 0).all()
            else:
                assert (m[b, :, i] > tref.NEG_INF).all()
                assert (l[b, :, i] > 0).all()


@pytest.mark.parametrize("bs", [8, 48])
def test_paged_split_partials_never_read_entries_past_seq_len(bs):
    """Table entries past a sequence's live pages are never read: page
    ids far outside the pool there change nothing."""
    q, kp, vp, tables, lens = _paged_case(bs, seed=2)
    trashed = tables.copy()
    for b, ln in enumerate(lens):
        trashed[b, -(-int(ln) // bs):] = 10 ** 6
    want = tref.combine_split_partials(*tref.paged_decode_split_partials(
        *_torch(q, kp, vp, tables, lens), 3))
    got = tref.combine_split_partials(*tref.paged_decode_split_partials(
        *_torch(q, kp, vp, trashed, lens), 3))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_paged_split_partials_seq_len_one_is_the_first_value():
    """``seq_len == 1``: one position, weight exactly 1, so the output is
    that position's value (row 0 of page ``tables[b, 0]``) in every head
    of the group; ``seq_len == 0``: zeros."""
    q, kp, vp, tables, lens = _torch(*_paged_case(16, seed=3))
    out = tref.combine_split_partials(*tref.paged_decode_split_partials(
        q, kp, vp, tables, lens, 4))
    first = vp[int(tables[1, 0]), 0]                 # (KV, D)
    np.testing.assert_allclose(
        out[1].numpy(),
        torch.repeat_interleave(first, H // KV, dim=0).numpy(),
        **ORACLE_TOL)
    np.testing.assert_array_equal(out[0].numpy(), np.zeros((H, D)))


# ---------------------------------------------------------------------------
# the shared split plan at the paged kernel's shapes
# ---------------------------------------------------------------------------


def test_split_plan_at_the_chip_smoke_shape():
    """B 16, nb 13, bs 16 (208 positions, 4 tiles), starcoder2-3b heads
    (24/2) on 132 SMs: 4 splits of one tile, 2 x 16 x 4 = 128 CTAs."""
    n, per = tfd.split_plan(16, 24, 2, 13 * 16, 132)
    assert (n, per) == (4, 1)
    assert 2 * 16 * n == 128


@pytest.mark.parametrize("B,H_,KV_,nb,bs,want", [
    (16, 24, 2, 13, 16, (4, 1)),            # chip_smoke / the engine
    (1, 24, 2, 13, 16, (4, 1)),             # one sequence: one tile each
    (16, 24, 2, 4, 16, (1, 1)),             # 64 positions: one tile
    (16, 24, 2, 1, 16, (1, 1)),             # a single page
    (16, 24, 2, 5, 48, (4, 1)),             # bs 48: 240 positions
    (2, 24, 2, 256, 16, (64, 1)),           # long rows: 64 tiles
    (128, 32, 8, 256, 16, (1, 64)),         # the groups fill the card
])
def test_split_plan_at_paged_shapes(B, H_, KV_, nb, bs, want):
    n, per = tfd.split_plan(B, H_, KV_, nb * bs, 132)
    assert (n, per) == want
    n_tiles = -(-nb * bs // tfd.TILE)
    assert n * per >= n_tiles > (n - 1) * per          # covers, none empty


# ---------------------------------------------------------------------------
# the wrapper's host path (the launch itself stubbed: no card here)
# ---------------------------------------------------------------------------


class _NoHostRead(torch.Tensor):
    """A tensor whose values the host may not read: a read would wait on
    the card in the decode loop."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.item, torch.Tensor.tolist,
                    torch.Tensor.cpu, torch.Tensor.numpy, torch.Tensor.to,
                    torch.Tensor.__bool__, torch.Tensor.__int__,
                    torch.Tensor.__index__, torch.Tensor.__getitem__):
            raise AssertionError(f"seq_lens read on the host ({func})")
        return super().__torch_function__(func, types, args, kwargs or {})


def _stub_card(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "on_card", lambda x: True)
    monkeypatch.setattr(_build, "launch",
                        lambda module, symbol, argtypes, *args, device:
                        calls.append((module.NAME, symbol, args)))
    monkeypatch.setattr(tfd, "_sm_count", lambda device: 132)
    return calls


@pytest.mark.parametrize("nb,bs,want", [(13, 16, (4, 1)), (5, 48, (4, 1)),
                                        (1, 16, (1, 1))])
def test_wrapper_plans_from_shapes_alone(monkeypatch, nb, bs, want):
    calls = _stub_card(monkeypatch)
    B, Hq, KVq, Dq = 16, 24, 2, 128
    q = torch.zeros((B, Hq, Dq), dtype=torch.bfloat16)
    pages = torch.zeros((B * nb + 1, bs, KVq, Dq), dtype=torch.bfloat16)
    tables = torch.zeros((B, nb), dtype=torch.int32)
    lens = torch.full((B,), 7, dtype=torch.int32).as_subclass(_NoHostRead)
    out = tpfd.paged_flash_decode_attention(q, pages, pages, tables, lens)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert len(calls) == 1
    name, symbol, args = calls[0]
    assert (name, symbol) == ("paged_decode_attention",
                              "rtlm_paged_decode_attention")
    # ..., out, part, B, H, KV, D, bs, nb, n_splits, tiles_per_split, scale
    assert args[7:15] == (B, Hq, KVq, Dq, bs, nb) + want
    assert args[15] == pytest.approx(Dq ** -0.5)


@pytest.mark.parametrize("Dq", [100, 264])
def test_wrapper_refuses_head_dims_before_launch(monkeypatch, Dq):
    calls = _stub_card(monkeypatch)
    q = torch.zeros((2, 4, Dq), dtype=torch.bfloat16)
    pages = torch.zeros((5, 16, 2, Dq), dtype=torch.bfloat16)
    tables = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.ones((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        tpfd.paged_flash_decode_attention(q, pages, pages, tables, lens)
    assert calls == []
