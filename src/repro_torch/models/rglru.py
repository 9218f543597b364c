"""RG-LRU recurrent blocks (RecurrentGemma / Griffin, arXiv:2402.19427):
PyTorch port of ``repro.models.rglru``.

The recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) is a
first-order linear recurrence.  A prefill runs it as a log-depth doubling
scan (the counterpart of the reference's ``lax.associative_scan``:
ceil(log2 S) elementwise passes of static shape, so a CUDA graph
captures it); decode is an O(1) state update.  The gates run in float32
against float32 copies of ``w_a`` and ``w_i`` (TF32 stays off, PyTorch's
default for products), and the GELU is the tanh form, ``jax.nn.gelu``'s
default.  The scan combines in another order than XLA's, so its float32
results differ from the reference's by rounding only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import local as shlocal
from . import layers
from .ssm import causal_conv, conv_step, softplus

_C = 8.0  # Griffin's fixed exponent scale


def init_rglru_block(generator: torch.Generator, cfg, dtype,
                     device) -> dict:
    """The reference's init: dense leaves in ``dtype``; ``b_a``, ``b_i``
    and ``Lambda`` float32, Lambda such that sigmoid(Lambda)^8 is uniform
    in [0.9, 0.999]."""
    D = cfg.d_model
    lw = cfg.lru_width or D
    cw = cfg.ssm_conv_width
    u = 0.9 + 0.099 * torch.rand((lw,), generator=generator, device=device,
                                 dtype=torch.float32)
    lam = torch.log(u ** (1.0 / _C) / (1.0 - u ** (1.0 / _C)))

    def dense(shape, scale=0.02):
        return layers.dense_init(generator, shape, dtype, device, scale)

    def zeros32():
        return torch.zeros((lw,), dtype=torch.float32, device=device)

    return {
        "w_x": dense((D, lw)),
        "w_gate_branch": dense((D, lw)),
        "conv_w": dense((cw, lw), scale=0.1),
        "conv_b": torch.zeros((lw,), dtype=dtype, device=device),
        "w_a": dense((lw, lw)),
        "b_a": zeros32(),
        "w_i": dense((lw, lw)),
        "b_i": zeros32(),
        "Lambda": lam,
        "w_out": dense((lw, D)),
    }


def _rglru_coeffs(params, x):
    """x (..., lw) -> (a, gated input), both float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"])
    i = torch.sigmoid(xf @ params["w_i"].float() + params["b_i"])
    log_a = -_C * r * softplus(-params["Lambda"])   # log sigmoid(L)^(c r)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None):
    """The linear recurrence h_t = a_t h_{t-1} + b_t over axis 1, a, b
    (B, S, lw) float32, ``h0`` folded into step 0.  Returns (h (B, S, lw),
    final state (B, lw))."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    d = 1
    while d < S:
        # combine (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2)
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b, b[:, -1]


def _gelu_gate(x, w):
    return F.gelu((x @ w).float(), approximate="tanh")


def apply_recurrent_block(params: dict, x: torch.Tensor, cfg,
                          state: Optional[dict] = None):
    """Griffin's recurrent block over a sequence, x (B, S, D).  ``state``:
    None or ``{"conv": (B, W-1, lw), "h": (B, lw)}`` to continue from.
    Returns (out, {"conv", "h"})."""
    branch = x @ params["w_x"]
    gate = _gelu_gate(x, params["w_gate_branch"])
    # the causal conv of the ssm blocks without its activation
    conv, new_conv = causal_conv(branch, params["conv_w"], params["conv_b"],
                                 None if state is None else state["conv"])
    a, bterm = _rglru_coeffs(params, conv)
    h, h_final = rglru_scan(a, bterm, None if state is None else state["h"])
    y = (h * gate).to(x.dtype)
    return y @ params["w_out"], {"conv": new_conv, "h": h_final}


def decode_recurrent_block(params: dict, x: torch.Tensor, cfg,
                           state: dict):
    """One token, x (B, 1, D), against ``state`` {"conv", "h"}, which is
    updated IN PLACE.  Returns out (B, 1, D)."""
    x0 = x[:, 0]
    branch = x0 @ params["w_x"]                               # (B, lw)
    gate = _gelu_gate(x0, params["w_gate_branch"])
    conv, xp = conv_step(state["conv"], branch, params["conv_w"],
                         params["conv_b"])
    shlocal.copy_into(state["conv"], xp[:, 1:])
    a, bterm = _rglru_coeffs(params, conv)
    h = state["h"] * a + bterm
    shlocal.copy_into(state["h"], h)
    y = (h * gate).to(x.dtype)
    return (y @ params["w_out"])[:, None]
