"""PyTorch port: the MoE layer (``repro_torch.models.moe``) against
``repro.models.moe``, on the smoke configs of both MoE families
(mixtral-8x22b: 4 experts top-2; kimi-k2-1t-a32b: 4 experts top-2 and a
shared expert), the tests of tests/test_moe.py mirrored:

  * ample capacity — no choice dropped, the output equal to the
    reference's and to the dense oracle (every token through its top-k
    experts) within float32 rounding;
  * a capacity that drops — the routing plan (top-k expert ids, the
    stable sort, ``keep``) and ``moe_drop_frac`` identical to the
    reference's, the bf16 output within the port's bf16 rule
    (``kernels/compare.py``);
  * a padded stream — the same valid rows followed by more padding rows
    (what the fused prefill routes) give the reference's plan and drops
    at every padding;
  * the uniform router's load-balance loss is 1; the aux loss equals the
    reference's;
  * the expert-parallel dispatch is refused, naming its ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import configs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.kernels import compare  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

NAMES = ["mixtral-8x22b", "kimi-k2-1t-a32b"]
# float32: XLA and PyTorch sum the products in other orders
ATOL = 2e-5


def _cfg(name, capacity_factor):
    return dataclasses.replace(configs.get_smoke_config(name),
                               capacity_factor=capacity_factor)


def _params(cfg, dtype, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg, getattr(jnp, dtype))
    tp = {k: (convert.tensor_from_numpy(np.asarray(v), "cpu")
              if not isinstance(v, dict) else
              {kk: convert.tensor_from_numpy(np.asarray(vv), "cpu")
               for kk, vv in v.items()})
          for k, v in jp.items()}
    return jp, tp


def _x(cfg, shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    return jx, convert.tensor_from_numpy(np.asarray(jx), "cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_plan(p, x, cfg):
    """The reference's routing and dispatch plan, its own steps
    (src/repro/models/moe.py:68-89): top-k ids, the stable sort order,
    ``keep``."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = jmoe._capacity(T, cfg)
    xt = x.reshape(T, D)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p["router"], axis=-1)
    _, top_e = lax.top_k(probs, K)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(E))
    keep = jnp.arange(T * K) - seg_start[sorted_e] < C
    return np.asarray(top_e), np.asarray(order), np.asarray(keep)


def _port_plan(p, x, cfg):
    B, S, D = x.shape
    T = B * S
    _, _, _, top_e = tmoe.route(p, x.reshape(T, D), cfg)
    order, _, keep, _, _ = tmoe.dispatch(
        top_e, tmoe._capacity(T, cfg), cfg.num_experts)
    return top_e.numpy(), order.numpy(), keep.numpy()


def _dense_oracle(p, x, cfg):
    """Every token through its top-k experts, no capacity (the
    reference's tests/test_moe.py::dense_moe_oracle, in torch)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    _, _, top_p, top_e = tmoe.route(p, xt, cfg)
    out = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        h = F.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])
        w = torch.where(top_e == e, top_p, 0.0).sum(-1)
        out = out + (h @ p["w_down"][e]) * w[:, None].to(out.dtype)
    if cfg.num_shared_experts:
        out = out + tl.apply_mlp(p["shared"], xt, "swiglu")
    return out.reshape(B, S, D)


@pytest.mark.parametrize("name", NAMES)
def test_ample_capacity_matches_reference_and_dense_oracle(name):
    cfg = _cfg(name, 8.0)
    jp, tp = _params(cfg, "float32")
    jx, tx = _x(cfg, (2, 16), "float32")
    want, jaux = jmoe.apply_moe_local(jp, jx, cfg)
    got, taux = tmoe.apply_moe_local(tp, tx, cfg)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_f32(got), _f32(_dense_oracle(tp, tx, cfg)),
                               atol=ATOL, rtol=ATOL)
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) \
        == 0.0
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_dropping_capacity_keeps_the_references_plan(name, dtype):
    cfg = _cfg(name, 0.5)
    jp, tp = _params(cfg, dtype)
    jx, tx = _x(cfg, (4, 16), dtype)
    for a, b in zip(_port_plan(tp, tx, cfg), _jax_plan(jp, jx, cfg)):
        np.testing.assert_array_equal(a, b)
    want, jaux = jmoe.apply_moe_local(jp, jx, cfg)
    got, taux = tmoe.apply_moe_local(tp, tx, cfg)
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) > 0
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL,
                                   rtol=ATOL)
    else:
        # bf16: ``F.silu`` rounds once where ``jax.nn.silu`` rounds after
        # each step, an expert product may round its bf16 output the other
        # way after a sum in another order, and a token's sum of k
        # contributions may cancel to near zero: held to the port's bf16
        # rule, 2^-5 (|ref| + mean |ref|) an element (kernels/compare.py)
        want = torch.tensor(_f32(want))
        assert compare.within(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_padding_takes_capacity_as_in_the_reference(name):
    """The fused prefill routes its whole padded packed stream: the same
    20 valid rows followed by 12, 44 or 108 padding rows (the embedding
    of the pad token) get the reference's plan and drop fraction, which
    change with the padding."""
    cfg = _cfg(name, 0.5)
    jp, tp = _params(cfg, "float32")
    valid = np.random.default_rng(3).standard_normal((20, cfg.d_model))
    pad = np.random.default_rng(4).standard_normal((1, cfg.d_model))
    drops = []
    for total in (32, 64, 128):
        x = np.concatenate([valid, np.repeat(pad, total - 20, 0)])[None]
        x = x.astype(np.float32)
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
        for a, b in zip(_port_plan(tp, tx, cfg), _jax_plan(jp, jx, cfg)):
            np.testing.assert_array_equal(a, b)
        got, taux = tmoe.apply_moe_local(tp, tx, cfg)
        want, jaux = jmoe.apply_moe_local(jp, jx, cfg)
        assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
        np.testing.assert_allclose(_f32(got), _f32(want), atol=ATOL,
                                   rtol=ATOL)
        drops.append(float(taux["moe_drop_frac"]))
    assert len(set(drops)) > 1


@pytest.mark.parametrize("name", NAMES)
def test_uniform_router_load_balance_is_one(name):
    cfg = configs.get_smoke_config(name)
    jp, tp = _params(cfg, "float32")
    tp["router"] = torch.zeros_like(tp["router"])
    _, tx = _x(cfg, (2, 32), "float32")
    _, aux = tmoe.apply_moe_local(tp, tx, cfg)
    z = float(np.log(cfg.num_experts)) ** 2
    lb = (float(aux["moe_aux_loss"]) - cfg.router_z_weight * z) \
        / cfg.router_aux_weight
    assert abs(lb - 1.0) < 1e-5


def test_top_k_ties_go_to_the_lower_expert():
    """``lax.top_k``'s tie order, which the plan depends on."""
    cfg = configs.get_smoke_config("mixtral-8x22b")
    jp, tp = _params(cfg, "float32")
    tp["router"] = torch.zeros_like(tp["router"])
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    jx, tx = _x(cfg, (1, 8), "float32")
    for a, b in zip(_port_plan(tp, tx, cfg), _jax_plan(jp, jx, cfg)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_port_plan(tp, tx, cfg)[0],
                                  np.tile([0, 1], (8, 1)))


def test_apply_moe_is_the_single_device_path():
    cfg = configs.get_smoke_config("mixtral-8x22b")
    _, tp = _params(cfg, "float32")
    _, tx = _x(cfg, (1, 4), "float32")
    got, _ = tmoe.apply_moe(tp, tx, cfg)
    assert torch.equal(got, tmoe.apply_moe_local(tp, tx, cfg)[0])


def test_init_moe_layouts():
    cfg = configs.get_smoke_config("kimi-k2-1t-a32b")
    jp = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.bfloat16)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                       torch.bfloat16, "cpu")
    assert set(tp) == set(jp) and set(tp["shared"]) == set(jp["shared"])
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(tp[k].shape) == jp[k].shape
        assert str(tp[k].dtype).split(".")[1] == str(jp[k].dtype)
    assert tp["router"].dtype == torch.float32
    for k in tp["shared"]:
        assert tuple(tp["shared"][k].shape) == jp["shared"][k].shape
    # the reference's init scale
    assert abs(float(tp["w_gate"].float().std()) - 0.02) < 2e-3


def test_large_inits_are_drawn_a_slice_at_a_time(monkeypatch):
    """Past the slice size a tensor is drawn a leading-axis slice at a
    time (one kimi-k2 expert stack would need a 22.5 GB float32
    temporary): same shape, dtype and scale, and every slice drawn."""
    monkeypatch.setattr(tl, "_INIT_SLICE_BYTES", 4 * 64 * 8 * 3)
    w = tl.dense_init(torch.Generator().manual_seed(0), (10, 64, 8),
                      torch.bfloat16, "cpu")
    assert w.shape == (10, 64, 8) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 0.02) < 2e-3
    assert bool((w.float().abs().amax(dim=(1, 2)) > 0).all())
