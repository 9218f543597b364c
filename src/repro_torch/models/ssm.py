"""Mamba-2 (SSD, state-space duality) blocks: PyTorch port of
``repro.models.ssm``.

The chunked SSD algorithm (Dao & Gu 2024, arXiv:2405.21060): a quadratic,
attention-like term inside each chunk plus a linear recurrence of the
(heads, head_dim, state) tensor across chunks.  Decode is an O(1)
single-token state update.

The reference's casts are kept, because the port is held to it on the
CPU: the decay factors and the carried states are rounded to the input
dtype before their contractions (which then run in float32, the
reference's ``preferred_element_type``), and ``dt`` is rounded to the
input dtype where it scales ``x`` while ``dt * A`` stays float32.  Each
multi-operand ``einsum`` of the reference is a fixed sequence of
pairwise products here, in an order that keeps the (b, c, h, q, k) term
the largest temporary (``torch.einsum`` would let ``opt_einsum`` pick
the order where it is installed).  The reference's ``lax.scan`` over
chunks is a Python loop over the static chunk count, and the two conv
forms stay as the reference writes them: prefill a sum of W products in
the input dtype, decode a float32 reduction rounded once.  Plain PyTorch
ops only (the reference has no Pallas kernel here); none reads the
device on the host, so a CUDA graph captures every function.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import context as shctx
from ..sharding import local as shlocal
from . import layers


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)), without ``F.softplus``'s linear cut-off."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T), out[i, j] = sum(a[j+1..i]) by cumsum
    differences, -inf above the diagonal (the reference's form)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, -math.inf)


def init_mamba2(generator: torch.Generator, cfg, dtype, device) -> dict:
    """The reference's init: dense leaves in ``dtype``; ``A_log``,
    ``dt_bias`` and ``D`` float32 (A uniform in [1, 16], dt log-uniform in
    [1e-3, 1e-1] through the inverse softplus)."""
    D = cfg.d_model
    di, nh, ns = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
    g, cw = cfg.ssm_groups, cfg.ssm_conv_width
    conv_dim = di + 2 * g * ns

    def uniform(lo, hi):
        u = torch.rand((nh,), generator=generator, device=device,
                       dtype=torch.float32)
        return lo + (hi - lo) * u

    a = uniform(1.0, 16.0)
    dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_proj": layers.dense_init(
            generator, (D, 2 * di + 2 * g * ns + nh), dtype, device),
        "conv_w": layers.dense_init(generator, (cw, conv_dim), dtype, device,
                                    scale=0.1),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(a),
        "dt_bias": dt_bias,
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": layers.dense_init(generator, (di, D), dtype, device),
    }


def _split_proj(proj: torch.Tensor, cfg):
    di, nh, ns, g = (cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state,
                     cfg.ssm_groups)
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * g * ns]
    dt = proj[..., -nh:]
    return z, xBC, dt


def causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, the prefill form: xBC (B, S, C),
    w (W, C), ``state`` the previous W-1 inputs (zeros when None).
    Returns (the sum of W products in the input dtype, plus the bias;
    the new state, the last W-1 inputs).  No activation: the callers
    apply their own."""
    W = w.shape[0]
    S = xBC.shape[1]
    if state is None:
        state = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[-1]))
    xp = torch.cat([state.to(xBC.dtype), xBC], dim=1)   # (B, S+W-1, C)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, -(W - 1):]


def conv_step(conv_state: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor):
    """The decode form: append x (B, C) to the (B, W-1, C) state; the
    window's products summed in float32 and rounded once (the reference's
    ``einsum("bwc,wc->bc")``), plus the bias.  Returns (out, the window
    (B, W, C), whose last W-1 rows are the new state)."""
    xp = torch.cat([conv_state.to(x.dtype), x[:, None]], dim=1)
    out = (xp.float() * w.float()).sum(dim=1).to(x.dtype)
    return out + b, xp


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (b, s, h, p), already multiplied by dt; a (b, s, h) = dt * A
    (negative, float32); B_, C_ (b, s, g, n), the h heads in g groups.
    Returns (y (b, s, h, p) in x's dtype, final state (b, h, p, n)
    float32).  Under a policy each rank scans its shards
    (``_ssd_on_shards``)."""
    if shctx.current() is not None and shlocal.is_dtensor(x):
        return _ssd_on_shards(x, a, B_, C_, chunk, init_state)
    b, s, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    Q = min(chunk, s)
    nc = -(-s // Q)
    pad = nc * Q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    dt = x.dtype
    f32 = torch.float32

    # heads-major views; a group's B/C serve its ``rep`` heads
    xc = x.reshape(b, nc, Q, h, p).permute(0, 1, 3, 2, 4).float()
    ac = a.reshape(b, nc, Q, h).permute(0, 3, 1, 2)           # (b,h,nc,Q)
    Bg = B_.reshape(b, nc, Q, g, n).permute(0, 1, 3, 2, 4).float()
    Cg = C_.reshape(b, nc, Q, g, n).permute(0, 1, 3, 2, 4).float()

    def heads(t):              # (b, c, g, ...) -> (b, c, h, ...)
        return t.repeat_interleave(rep, dim=2) if rep > 1 else t

    acs = torch.cumsum(ac, dim=-1)                            # (b,h,nc,Q)
    L = torch.exp(_segsum(ac)).to(dt).to(f32)                 # (b,h,nc,Q,Q)
    # y_diag[q] = sum_k (C_q . B_k) L[q, k] x_k
    scores = heads(Cg @ Bg.transpose(-1, -2))                 # (b,c,h,Q,Q)
    y_diag = (scores * L.permute(0, 2, 1, 3, 4)) @ xc         # (b,c,h,Q,p)

    # each chunk's own state: sum_k decay_k x_k (x) B_k
    decay_states = torch.exp(acs[..., -1:] - acs).to(dt).to(f32)
    xd = xc * decay_states.permute(0, 2, 1, 3)[..., None]     # (b,c,h,Q,p)
    states = xd.transpose(-1, -2) @ heads(Bg)                 # (b,c,h,p,n)
    chunk_decay = torch.exp(acs[..., -1])                     # (b,h,nc)

    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1).to(dt).to(f32)            # (b,c,h,p,n)

    # y_off[q] = exp(acs_q) C_q . prev
    y_off = ((heads(Cg) @ prev.transpose(-1, -2))
             * torch.exp(acs).to(dt).to(f32).permute(0, 2, 1, 3)[..., None])
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, nc * Q, h, p)
    return y[:, :s].to(dt), carry


def _ssd_on_shards(x, a, B_, C_, chunk: int, init_state):
    """``ssd_chunked`` on this rank's shards: x and a laid out by batch
    and heads, B_/C_ by batch (the rank takes the groups of its heads, or
    its heads' rows of the expanded groups where a shard splits a group),
    the scan local; B_/C_ gradients are partial over the axes that split
    the heads."""
    from torch.distributed.tensor import Partial, Shard
    policy = shctx.current()
    x = policy.constrain(x, ("batch", None, "heads", None))
    a = policy.constrain(a, ("batch", None, "heads"))
    grp = ("batch", None, None, None)
    B_, C_ = policy.constrain(B_, grp), policy.constrain(C_, grp)
    h, g = x.shape[2], B_.shape[2]
    rep = h // g
    h0, hn = shlocal.local_range(x, 2)
    grads = [pb if pb.is_shard() else Partial() if px.is_shard() else pb
             for pb, px in zip(B_.placements, x.placements)]

    def groups(t):
        t = t.to_local(grad_placements=grads)
        if h0 % rep == 0 and hn % rep == 0:
            return t[:, :, h0 // rep:(h0 + hn) // rep]
        return t.repeat_interleave(rep, dim=2)[:, :, h0:h0 + hn]
    state_pl = [Shard(1) if p.is_shard() and p.dim == 2 else p
                for p in x.placements]
    if init_state is not None:
        init_state = policy.constrain(
            init_state, ("batch", "heads", None, None)).to_local()
    y, final = ssd_chunked(x.to_local(), a.to_local(), groups(B_),
                           groups(C_), chunk, init_state)
    return shlocal.wrap(y, x), shlocal.wrap(final, x, state_pl)


def apply_mamba2(params: dict, x: torch.Tensor, cfg,
                 state: Optional[dict] = None):
    """The whole Mamba-2 mixer over a sequence, x (B, S, D).  ``state``:
    None (a prefill from scratch) or ``{"conv": (B, W-1, convdim), "ssd":
    (B, H, P, N)}`` to continue from.  Returns (out, {"conv", "ssd"})."""
    B, S, _ = x.shape
    nh, ns, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    p, di = cfg.ssm_head_dim, cfg.ssm_d_inner
    proj = x @ params["in_proj"]
    z, xBC, dt = _split_proj(proj, cfg)
    conv, conv_state = causal_conv(xBC, params["conv_w"], params["conv_b"],
                                   None if state is None else state["conv"])
    xBC = F.silu(conv)
    xs = xBC[..., :di].reshape(B, S, nh, p)
    xs = shctx.constrain(xs, ("batch", None, "heads", None))
    B_ = xBC[..., di:di + g * ns].reshape(B, S, g, ns)
    C_ = xBC[..., di + g * ns:].reshape(B, S, g, ns)
    dt = softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])                           # (nh,)
    a = dt * A                                                # (B, S, nh)
    x_in = xs * dt[..., None].to(xs.dtype)
    y, final = ssd_chunked(x_in, a, B_, C_, cfg.ssm_chunk,
                           None if state is None else state["ssd"])
    y = y + xs * params["D"][None, None, :, None].to(xs.dtype)
    y = layers.gated_rms_norm(y.reshape(B, S, di), z, params["norm"],
                              cfg.norm_eps)
    return y @ params["out_proj"], {"conv": conv_state, "ssd": final}


def _read_state(h, C, like):
    """h (B, nh, p, ns) times C (B, nh, ns) over ns.  Under a policy the
    product runs on local shards, h and C laid out as the ``ssd`` state
    ``like`` (batch and heads): as one product over the flattened
    (B, nh) it would put two mesh axes' shards in one dim, which DTensor
    (torch 2.11) refuses."""
    if not shlocal.is_dtensor(h):
        return (h @ C[..., None])[..., 0]
    h = shlocal.layout_like(h, like)
    C = shlocal.layout_like(C, like)
    return shlocal.wrap((h.to_local() @ C.to_local()[..., None])[..., 0], h)


def decode_mamba2(params: dict, x: torch.Tensor, cfg, state: dict):
    """One token, x (B, 1, D), against ``state`` {"conv", "ssd"}, which
    is updated IN PLACE (conv in its own dtype).  Returns out
    (B, 1, D)."""
    B = x.shape[0]
    nh, ns, g, p = (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups,
                    cfg.ssm_head_dim)
    di = cfg.ssm_d_inner
    proj = x[:, 0] @ params["in_proj"]                        # (B, ...)
    z, xBC, dt = _split_proj(proj, cfg)
    conv, xp = conv_step(state["conv"], xBC, params["conv_w"],
                         params["conv_b"])
    shlocal.copy_into(state["conv"], xp[:, 1:])
    xBC = F.silu(conv)
    xs = xBC[..., :di].reshape(B, nh, p)
    rep = nh // g
    Bh = xBC[..., di:di + g * ns].reshape(B, g, ns).repeat_interleave(
        rep, dim=1).float()                                   # (B, nh, ns)
    Ch = xBC[..., di + g * ns:].reshape(B, g, ns).repeat_interleave(
        rep, dim=1).float()
    dt = softplus(dt.float() + params["dt_bias"])             # (B, nh)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)
    dBx = (dt[..., None, None] * xs.float()[..., None]) * Bh[:, :, None, :]
    h_new = state["ssd"] * decay[..., None, None] + dBx       # (B,nh,p,ns)
    shlocal.copy_into(state["ssd"], h_new)
    y = _read_state(h_new, Ch, state["ssd"])                  # (B, nh, p)
    y = y.to(xs.dtype) + xs * params["D"][None, :, None].to(xs.dtype)
    y = layers.gated_rms_norm(y.reshape(B, di), z, params["norm"],
                              cfg.norm_eps)
    return (y @ params["out_proj"])[:, None]
