"""PyTorch port: sliding-window attention against ``repro.models.layers``.

  * ``windowed_attention`` — the O(S * window) prefill scheme (query
    chunks against a ``window + q_chunk`` key span, K/V padded left by
    the window) at S past the window, with several query chunks and a
    padded last one, in float32 and bf16; and at S within the window,
    where both fall back to full causal attention;
  * ``chunked_attention`` with a window — the mask ``q - k < window``;
  * ``decode_attention`` with a window on a ring that has wrapped: per-slot
    rows whose ring slots hold non-monotonic positions, some slots
    empty, each row at its own position.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

# float32: XLA and PyTorch sum in other orders; bf16: probabilities cast
# to the value dtype before P.V in both, so outputs agree to a bf16 ulp
TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}


def _qkv(B, S, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV)]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,q_chunk", [
    (40, 12, 16),            # three query chunks, the last one padded
    (33, 8, 33),             # one chunk
    (20, 20, 8),             # window == S: full causal attention
    (12, 64, 8),             # window past S
])
def test_windowed_attention_matches_reference(S, window, q_chunk, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, S, 8, 2, 16, dtype)
    pos = np.arange(S, dtype=np.int32)
    want = jl.windowed_attention(jq, jk, jv, q_positions=jnp.asarray(pos),
                                 kv_positions=jnp.asarray(pos),
                                 window=window, q_chunk=q_chunk)
    got = tl.windowed_attention(tq, tk, tv, q_positions=torch.from_numpy(pos),
                                kv_positions=torch.from_numpy(pos),
                                window=window, q_chunk=q_chunk)
    assert got.shape == (2, S, 8, 16) and got.dtype == tq.dtype
    _close(got, want, dtype)


def test_windowed_attention_sees_only_the_window():
    """A query's output moves with a key inside its window and not with
    one outside it."""
    (_, (q, k, v)) = _qkv(1, 30, 4, 4, 8, "float32")
    pos = torch.arange(30)
    base = tl.windowed_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                 window=5, q_chunk=8)
    v2 = v.clone()
    v2[:, 10] += 5.0                         # inside 10..14's windows only
    out = tl.windowed_attention(q, k, v2, q_positions=pos, kv_positions=pos,
                                window=5, q_chunk=8)
    moved = (out - base).abs().amax(dim=(0, 2, 3)) > 0
    assert moved.nonzero().flatten().tolist() == list(range(10, 15))


@pytest.mark.parametrize("window", [None, 3, 7])
def test_chunked_attention_window_matches_reference(window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 9, 8, 2, 16, "float32", seed=1)
    (_, jk, jv), (_, tk, tv) = _qkv(2, 20, 8, 2, 16, "float32", seed=2)
    qp = np.arange(9, dtype=np.int32) + 11
    kp = np.arange(20, dtype=np.int32)
    want = jl.chunked_attention(jq, jk, jv, q_positions=jnp.asarray(qp),
                                kv_positions=jnp.asarray(kp), causal=True,
                                window=window, kv_chunk=8)
    got = tl.chunked_attention(tq, tk, tv, q_positions=torch.from_numpy(qp),
                               kv_positions=torch.from_numpy(kp),
                               causal=True, window=window, kv_chunk=8)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_window_on_a_wrapped_ring(dtype):
    """A 16-row ring per slot: slot 0 has wrapped (positions 32..47 in
    ring order 32 % 16 ...), slot 1 has wrapped less far, slot 2 holds
    only positions 0..4 (the rest empty at 2^30).  Window 6."""
    W, window = 16, 6
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, W, 8, 2, 16, dtype, seed=3)
    jq, tq = jq[:, :1], tq[:, :1]
    q_pos = np.asarray([47, 20, 4], np.int32)
    kv_pos = np.full((3, W), 2**30, np.int32)
    for row, p in enumerate(q_pos):
        for t in range(max(0, p - W + 1), p + 1):
            kv_pos[row, t % W] = t
    valid = np.minimum(q_pos + 1, W)
    want = jl.decode_attention(jq, jk, jv, q_position=jnp.asarray(q_pos),
                               kv_positions=jnp.asarray(kv_pos),
                               valid_len=jnp.asarray(valid), window=window)
    got = tl.decode_attention(tq, tk, tv, q_position=torch.from_numpy(q_pos),
                              kv_positions=torch.from_numpy(kv_pos),
                              valid_len=torch.from_numpy(valid),
                              window=window)
    _close(got, want, dtype)
    # the batch form: one shared position, a (W,) position row
    want = jl.decode_attention(jq, jk, jv, q_position=jnp.int32(47),
                               kv_positions=jnp.asarray(kv_pos[0]),
                               valid_len=jnp.int32(16), window=window)
    got = tl.decode_attention(tq, tk, tv, q_position=torch.tensor(47),
                              kv_positions=torch.from_numpy(kv_pos[0]),
                              valid_len=torch.tensor(16), window=window)
    _close(got, want, dtype)
