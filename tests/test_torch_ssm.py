"""PyTorch port: the Mamba-2 SSD layer (``repro_torch.models.ssm``) and
``layers.gated_rms_norm`` against ``repro.models.ssm`` /
``repro.models.layers``, on inputs made from a numpy seed.

  * ``ssd_chunked`` at chunks 4, 8 and 64 and a length that is no
    multiple of its chunk (the padding path), with and without
    ``init_state``: float32 outputs and final states within rtol = atol =
    1e-4 of JAX's, and of the reference's own naive step-by-step
    recurrence (tests/test_ssm.py); bf16 inputs (``a`` float32, as
    ``apply_mamba2`` passes it) within ``BF16``;
  * ``apply_mamba2`` from scratch and from a carried state, and
    ``decode_mamba2`` steps, on the mamba2-1.3b smoke config: float32
    outputs and states within 1e-4 of JAX's, bf16 within ``BF16``; S
    decode steps equal the prefill (the reference's own check);
  * ``gated_rms_norm`` in float32 and bf16.

Float32 parts differ from XLA's by summation order only.  bf16 parts
round where the reference rounds, but XLA on the CPU may keep excess
precision across fused elementwise ops, so a bf16 element may sit an ulp
or two away: ``BF16`` is two bf16 ulps (2^-7 relative) plus 2^-7 of the
output's largest magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
#: bf16: relative, and as a share of the output's largest magnitude
BF16 = 2.0 ** -7
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(a, dtype: str):
    """One numpy array as a JAX array and a tensor of ``dtype``, holding
    the same values (bf16 rounded once, by JAX, and copied bit for
    bit)."""
    j = jnp.asarray(a).astype(DTYPES[dtype])
    return j, convert.tensor_from_numpy(np.asarray(j), "cpu")


def assert_close(got, want, dtype: str = "float32"):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16,
                                   atol=BF16 * float(np.abs(want).max()))


def _ssd_inputs(s, seed=0, b=2, h=4, p=8, g=2, n=6):
    r = _rng(seed)
    x = r.standard_normal((b, s, h, p)).astype(np.float32)
    a = -np.log1p(np.exp(r.standard_normal((b, s, h)))).astype(np.float32)
    B_ = r.standard_normal((b, s, g, n)).astype(np.float32)
    C_ = r.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = r.standard_normal((b, h, p, n)).astype(np.float32)
    return x, a, B_, C_, h0


def _naive_ssd(x, a, B_, C_, h0):
    """The reference test's step-by-step recurrence (tests/test_ssm.py),
    in float64 numpy, from ``h0``."""
    b, s, h, p = x.shape
    rep = h // B_.shape[2]
    Bh, Ch = (np.repeat(t, rep, axis=2).astype(np.float64) for t in (B_, C_))
    st = h0.astype(np.float64)
    ys = []
    for t in range(s):
        st = (st * np.exp(a[:, t])[..., None, None]
              + np.einsum("bhn,bhp->bhpn", Bh[:, t], x[:, t]))
        ys.append(np.einsum("bhn,bhpn->bhp", Ch[:, t], st))
    return np.stack(ys, axis=1), st


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("chunk,s", [(4, 24), (8, 24), (64, 24), (8, 21)],
                         ids=["c4", "c8", "c64", "c8-padded"])
def test_ssd_chunked_matches_jax_and_the_naive_recurrence(chunk, s, init):
    x, a, B_, C_, h0 = _ssd_inputs(s, seed=chunk + s)
    st = h0 if init else None
    y, final = tssm.ssd_chunked(
        *(torch.from_numpy(t) for t in (x, a, B_, C_)), chunk,
        None if st is None else torch.from_numpy(st))
    jy, jfinal = jssm.ssd_chunked(
        *(jnp.asarray(t) for t in (x, a, B_, C_)), chunk,
        None if st is None else jnp.asarray(st))
    assert y.dtype == torch.float32 and final.dtype == torch.float32
    assert_close(y, jy)
    assert_close(final, jfinal)
    ny, nfinal = _naive_ssd(x, a, B_, C_, h0 if init else 0 * h0)
    np.testing.assert_allclose(y.numpy(), ny, **F32)
    np.testing.assert_allclose(final.numpy(), nfinal, **F32)


@pytest.mark.parametrize("chunk,s", [(8, 24), (8, 21)],
                         ids=["c8", "c8-padded"])
def test_ssd_chunked_bf16_matches_jax(chunk, s):
    x, a, B_, C_, h0 = _ssd_inputs(s, seed=7)
    (jx, tx), (jb, tb), (jc, tc) = (_pair(t, "bfloat16") for t in (x, B_, C_))
    y, final = tssm.ssd_chunked(tx, torch.from_numpy(a), tb, tc, chunk,
                                torch.from_numpy(h0))
    jy, jfinal = jssm.ssd_chunked(jx, jnp.asarray(a), jb, jc, chunk,
                                  jnp.asarray(h0))
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    assert_close(y, jy, "bfloat16")
    assert_close(final, jfinal, "bfloat16")


def test_ssd_chunk_continuation():
    """Two chunked calls with the state carried equal one long call (the
    reference's own check, on the port)."""
    x, a, B_, C_, _ = _ssd_inputs(16, seed=3, b=1, h=2, p=4, g=1, n=4)
    t = [torch.from_numpy(v) for v in (x, a, B_, C_)]
    y_full, final_full = tssm.ssd_chunked(*t, 4)
    y1, st = tssm.ssd_chunked(*(v[:, :8] for v in t), 4)
    y2, final2 = tssm.ssd_chunked(*(v[:, 8:] for v in t), 4, init_state=st)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, **F32)
    torch.testing.assert_close(final2, final_full, **F32)


@pytest.fixture(scope="module")
def mixers():
    """The smoke mamba2 mixer's reference parameters in each dtype, as JAX
    and as port trees (float32 leaves kept, as the bridge keeps them)."""
    import jax
    cfg = configs.get_smoke_config("mamba2-1.3b")
    out = {}
    for name, jdt in DTYPES.items():
        jp = jssm.init_mamba2(jax.random.PRNGKey(1), cfg, jdt)
        tp = {k: convert.tensor_from_numpy(np.asarray(v), "cpu")
              for k, v in jp.items()}
        out[name] = (jp, tp)
    return cfg, out


def _x(cfg, B, S, dtype, seed):
    return _pair(0.5 * _rng(seed).standard_normal((B, S, cfg.d_model)),
                 dtype)


def _state_pair(cfg, B, dtype, seed):
    r = _rng(seed)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    jc, tc = _pair(0.5 * r.standard_normal(
        (B, cfg.ssm_conv_width - 1, conv_dim)), dtype)
    ssd = 0.1 * r.standard_normal((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state)).astype(np.float32)
    # the port's state is updated in place: no buffer shared with JAX's
    return ({"conv": jc, "ssd": jnp.asarray(ssd)},
            {"conv": tc, "ssd": torch.from_numpy(ssd.copy())})


@pytest.mark.parametrize("carried", [False, True],
                         ids=["scratch", "carried"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mamba2_matches_jax(mixers, dtype, carried):
    """S 20 at the smoke chunk 8: three chunks, the last padded."""
    cfg, trees = mixers
    jp, tp = trees[dtype]
    jx, tx = _x(cfg, 2, 20, dtype, seed=2)
    js, ts = _state_pair(cfg, 2, dtype, seed=3) if carried else (None, None)
    y, st = tssm.apply_mamba2(tp, tx, cfg, ts)
    jy, jst = jssm.apply_mamba2(jp, jx, cfg, js)
    assert y.dtype == tx.dtype and st["ssd"].dtype == torch.float32
    assert_close(y, jy, dtype)
    assert_close(st["ssd"], jst["ssd"], dtype)
    assert_close(st["conv"], jst["conv"], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_mamba2_matches_jax(mixers, dtype):
    """Four steps from a carried state, the state updated in place."""
    cfg, trees = mixers
    jp, tp = trees[dtype]
    js, ts = _state_pair(cfg, 2, dtype, seed=4)
    jx, tx = _x(cfg, 2, 4, dtype, seed=5)
    conv, ssd = ts["conv"], ts["ssd"]
    for t in range(4):
        y = tssm.decode_mamba2(tp, tx[:, t:t + 1], cfg, ts)
        jy, js = jssm.decode_mamba2(jp, jx[:, t:t + 1], cfg, js)
        assert y.shape == (2, 1, cfg.d_model)
        assert_close(y, jy, dtype)
        assert_close(ts["ssd"], js["ssd"], dtype)
        assert_close(ts["conv"], js["conv"], dtype)
    assert ts["conv"] is conv and ts["ssd"] is ssd


def test_decode_mamba2_steps_equal_the_prefill(mixers):
    """S single-token steps from zeros equal one prefill of S tokens."""
    cfg, trees = mixers
    _, tp = trees["float32"]
    _, tx = _x(cfg, 2, 10, "float32", seed=6)
    y_seq, st_seq = tssm.apply_mamba2(tp, tx, cfg, None)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    st = {"conv": torch.zeros((2, cfg.ssm_conv_width - 1, conv_dim)),
          "ssd": torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state))}
    ys = [tssm.decode_mamba2(tp, tx[:, t:t + 1], cfg, st) for t in range(10)]
    torch.testing.assert_close(torch.cat(ys, 1), y_seq, rtol=1e-3,
                               atol=1e-3)
    torch.testing.assert_close(st["ssd"], st_seq["ssd"], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gated_rms_norm_matches_jax(dtype):
    r = _rng(8)
    jx, tx = _pair(r.standard_normal((3, 5, 64)), dtype)
    jz, tz = _pair(2.0 * r.standard_normal((3, 5, 64)), dtype)
    jw, tw = _pair(0.1 * r.standard_normal(64), dtype)
    got = tlayers.gated_rms_norm(tx, tz, tw, 1e-6)
    assert got.dtype == tx.dtype
    assert_close(got, jlayers.gated_rms_norm(jx, jz, jw, 1e-6), dtype)


def test_softplus_is_jaxs():
    import jax
    x = np.linspace(-40.0, 40.0, 801, dtype=np.float32)
    np.testing.assert_allclose(tssm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)
