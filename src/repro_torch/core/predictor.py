"""The lightweight (LW) uncertainty-score predictor (paper §III-B, Alg. 1).

PyTorch port of ``repro.core.predictor``: an MLP with hidden sizes
[100, 200, 200, 100] and ReLU, trained with Adam to minimise the MSE (or,
optionally, the pinball loss) between predicted and true output lengths:
u_J = m_theta(RULEGEN(J)).

Parameters keep the reference's layout — a list of ``{"w": (a, b),
"b": (b,)}`` float32 tensors — so ``repro_torch.models.convert.
predictor_from_numpy`` carries trained reference weights over unchanged.
Initialisation draws from an explicit ``torch.Generator``; it therefore
gives other numbers than the reference's ``jax.random`` for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import datagen, rulegen

HIDDEN = (100, 200, 200, 100)


def init_mlp(generator: torch.Generator, in_dim: int = rulegen.FEATURE_DIM,
             hidden: Sequence[int] = HIDDEN, device=None) -> list:
    """He-normal weights, zero biases.  ``generator`` must live on
    ``device``."""
    device = resolve_device(device)
    sizes = (in_dim,) + tuple(hidden) + (1,)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator, device=device,
                        dtype=torch.float32) * (2.0 / a) ** 0.5
        params.append({"w": w, "b": torch.zeros((b,), device=device)})
    return params


def mlp_apply(params: list, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h[..., 0]


def _loss(params, x, y, quantile=None):
    pred = mlp_apply(params, x)
    if quantile is None:
        return torch.mean(torch.square(pred - y))
    # pinball loss (beyond-paper, as in the reference): a tail-aware
    # predictor of e.g. the P90 output length
    err = y - pred
    return torch.mean(torch.maximum(quantile * err, (quantile - 1.0) * err))


def _adam_step(params, m, v, t: int, x, y, lr=1e-4, b1=0.9, b2=0.999,
               eps=1e-8, quantile=None):
    """One Adam step; returns (params, m, v, t, loss) like the reference
    (new tensors, the inputs are left untouched)."""
    leaves = [p[k].detach().requires_grad_(True)
              for p in params for k in ("w", "b")]
    live = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
            for i in range(len(params))]
    loss = _loss(live, x, y, quantile)
    grads = torch.autograd.grad(loss, leaves)
    t = t + 1
    # the reference raises b1, b2 to the step count in float32
    tf = torch.tensor(float(t), dtype=torch.float32)
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** tf)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** tf)
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for i, layer in enumerate(params):
            lp, lm, lv = {}, {}, {}
            for j, k in enumerate(("w", "b")):
                g = grads[2 * i + j]
                mk = b1 * m[i][k] + (1 - b1) * g
                vk = b2 * v[i][k] + (1 - b2) * g * g
                lp[k] = layer[k] - lr * (mk / c1) / (torch.sqrt(vk / c2)
                                                     + eps)
                lm[k], lv[k] = mk, vk
            new_p.append(lp)
            new_m.append(lm)
            new_v.append(lv)
    return new_p, new_m, new_v, t, loss.detach()


@dataclasses.dataclass
class Predictor:
    params: list
    mean: np.ndarray
    std: np.ndarray
    train_losses: list

    @property
    def device(self) -> torch.device:
        return self.params[0]["w"].device

    def _features(self, texts: Sequence[str]) -> torch.Tensor:
        f = np.stack([rulegen.features(t) for t in texts])
        f = ((f - self.mean) / self.std).astype(np.float32)
        return torch.from_numpy(f).to(self.device)

    @torch.no_grad()
    def score(self, text: str) -> float:
        """u_J = m_theta(RULEGEN(J)) — predicted output length (tokens)."""
        return float(mlp_apply(self.params, self._features([text]))[0])

    @torch.no_grad()
    def score_batch(self, texts: Sequence[str]) -> np.ndarray:
        return mlp_apply(self.params, self._features(texts)).cpu().numpy()


def extract_xy(tasks: Sequence[datagen.Task], persona: str):
    x = np.stack([rulegen.features(t.text) for t in tasks])
    y = np.array([t.out_lens[persona] for t in tasks], np.float32)
    return x, y


def train_predictor(tasks: Sequence[datagen.Task], persona: str,
                    *, epochs: int = 100, batch_size: int = 64,
                    lr: float = 1e-3, seed: int = 0,
                    quantile: Optional[float] = None,
                    device=None) -> Predictor:
    device = resolve_device(device)
    x, y = extract_xy(tasks, persona)
    mean = x.mean(axis=0)
    std = x.std(axis=0) + 1e-6
    xn = (x - mean) / std

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_mlp(gen, device=device)
    m = [{k: torch.zeros_like(p[k]) for k in p} for p in params]
    v = [{k: torch.zeros_like(p[k]) for k in p} for p in params]
    t = 0

    n = len(xn)
    rng = np.random.default_rng(seed)
    losses: List[float] = []
    xt = torch.from_numpy(xn.astype(np.float32)).to(device)
    yt = torch.from_numpy(y).to(device)
    for _ in range(epochs):
        perm = rng.permutation(n)
        ep_loss = 0.0
        nb = 0
        for s in range(0, n, batch_size):
            idx = torch.from_numpy(perm[s:s + batch_size]).to(device)
            params, m, v, t, loss = _adam_step(
                params, m, v, t, xt[idx], yt[idx], lr=lr, quantile=quantile)
            ep_loss += float(loss)
            nb += 1
        losses.append(ep_loss / max(nb, 1))
    return Predictor(params=params, mean=mean, std=std, train_losses=losses)


def fit_weighted_rule(tasks: Sequence[datagen.Task],
                      persona: str) -> np.ndarray:
    """§III-B 'weighted rule': least-squares weights over the features."""
    x, y = extract_xy(tasks, persona)
    w, *_ = np.linalg.lstsq(
        np.concatenate([x, np.ones((len(x), 1))], axis=1), y, rcond=None)
    return w.astype(np.float32)
