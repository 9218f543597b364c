"""PyTorch port: the RG-LRU recurrent block (``repro_torch.models.rglru``)
against ``repro.models.rglru``, on inputs made from a numpy seed.

  * ``rglru_scan`` — the log-depth doubling scan against the reference's
    ``lax.associative_scan`` and against a step-by-step loop, with and
    without ``h0``, at lengths that are and are not powers of two;
  * ``apply_recurrent_block`` from scratch and from a carried state, and
    ``decode_recurrent_block`` steps, on the recurrentgemma-9b smoke
    config; S decode steps equal the prefill (the reference's own check).

Float32 outputs and states within rtol = atol = 1e-4 of JAX's (the two
scans combine in other orders, so they differ by rounding); bf16 within
``test_torch_ssm.BF16`` (two bf16 ulps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_ssm import DTYPES, F32, _pair, assert_close  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402


def _scan_inputs(S, seed, B=2, W=8):
    r = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-r.standard_normal((B, S, W))))).astype(
        np.float32)
    b = r.standard_normal((B, S, W)).astype(np.float32)
    h0 = r.standard_normal((B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("S", [1, 12, 16, 37])
def test_rglru_scan_matches_jax_and_the_loop(S, h0):
    a, b, h = _scan_inputs(S, seed=S)
    h = h if h0 else None
    got, final = trg.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                                None if h is None else torch.from_numpy(h))
    want, jfinal = jrg.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                  None if h is None else jnp.asarray(h))
    assert got.shape == a.shape and final.shape == (a.shape[0], a.shape[2])
    assert_close(got, want)
    assert_close(final, jfinal)
    ht = np.zeros_like(a[:, 0]) if h is None else h.astype(np.float64)
    loop = []
    for t in range(S):
        ht = a[:, t] * ht + b[:, t]
        loop.append(ht)
    np.testing.assert_allclose(got.numpy(), np.stack(loop, 1), **F32)


@pytest.fixture(scope="module")
def blocks():
    """The smoke recurrentgemma block's reference parameters in each
    dtype, as JAX and as port trees (float32 leaves kept)."""
    cfg = configs.get_smoke_config("recurrentgemma-9b")
    out = {}
    for name, jdt in DTYPES.items():
        jp = jrg.init_rglru_block(jax.random.PRNGKey(5), cfg, jdt)
        tp = {k: convert.tensor_from_numpy(np.asarray(v), "cpu")
              for k, v in jp.items()}
        out[name] = (jp, tp)
    return cfg, out


def _x(cfg, B, S, dtype, seed):
    return _pair(0.3 * np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)), dtype)


def _state_pair(cfg, B, dtype, seed):
    r = np.random.default_rng(seed)
    lw = cfg.lru_width or cfg.d_model
    jc, tc = _pair(0.3 * r.standard_normal((B, cfg.ssm_conv_width - 1, lw)),
                   dtype)
    h = r.standard_normal((B, lw)).astype(np.float32)
    # the port's state is updated in place: no buffer shared with JAX's
    return ({"conv": jc, "h": jnp.asarray(h)},
            {"conv": tc, "h": torch.from_numpy(h.copy())})


@pytest.mark.parametrize("carried", [False, True],
                         ids=["scratch", "carried"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_recurrent_block_matches_jax(blocks, dtype, carried):
    cfg, trees = blocks
    jp, tp = trees[dtype]
    jx, tx = _x(cfg, 2, 11, dtype, seed=6)
    js, ts = _state_pair(cfg, 2, dtype, seed=7) if carried else (None, None)
    y, st = trg.apply_recurrent_block(tp, tx, cfg, ts)
    jy, jst = jrg.apply_recurrent_block(jp, jx, cfg, js)
    assert y.dtype == tx.dtype and st["h"].dtype == torch.float32
    assert_close(y, jy, dtype)
    assert_close(st["h"], jst["h"], dtype)
    assert_close(st["conv"], jst["conv"], dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_recurrent_block_matches_jax(blocks, dtype):
    """Four steps from a carried state, the state updated in place."""
    cfg, trees = blocks
    jp, tp = trees[dtype]
    js, ts = _state_pair(cfg, 2, dtype, seed=8)
    jx, tx = _x(cfg, 2, 4, dtype, seed=9)
    conv, h = ts["conv"], ts["h"]
    for t in range(4):
        y = trg.decode_recurrent_block(tp, tx[:, t:t + 1], cfg, ts)
        jy, js = jrg.decode_recurrent_block(jp, jx[:, t:t + 1], cfg, js)
        assert y.shape == (2, 1, cfg.d_model)
        assert_close(y, jy, dtype)
        assert_close(ts["h"], js["h"], dtype)
        assert_close(ts["conv"], js["conv"], dtype)
    assert ts["conv"] is conv and ts["h"] is h


def test_decode_steps_equal_the_prefill(blocks):
    cfg, trees = blocks
    _, tp = trees["float32"]
    _, tx = _x(cfg, 2, 8, "float32", seed=10)
    y_seq, st_seq = trg.apply_recurrent_block(tp, tx, cfg, None)
    lw = cfg.lru_width or cfg.d_model
    st = {"conv": torch.zeros((2, cfg.ssm_conv_width - 1, lw)),
          "h": torch.zeros((2, lw))}
    ys = [trg.decode_recurrent_block(tp, tx[:, t:t + 1], cfg, st)
          for t in range(8)]
    torch.testing.assert_close(torch.cat(ys, 1), y_seq, **F32)
    torch.testing.assert_close(st["h"], st_seq["h"], **F32)
