"""Weight bridge: the JAX package's parameter trees, as numpy, into the port.

The port keeps the reference's tensor layouts (``wq (D, H, hd)``,
``wo (H, hd, D)``, ``embedding (V, D)``, ...), so the bridge is a copy: it
unstacks the reference's ``stack/scan0`` leading layer axis into the
port's per-layer list and converts every leaf, bit for bit (bf16 leaves
travel through their raw 16-bit pattern, since numpy has no bf16 that
torch reads).  Nothing here imports JAX: callers hand over
``jax.tree.map(np.asarray, params)``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import predictor as predictor_lib


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """One numpy leaf to a tensor on ``device``; a bf16 leaf (ml_dtypes)
    keeps its exact bits.  ``dtype`` casts after the exact copy."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_numpy(tree: dict, cfg, device, dtype=None) -> dict:
    """The reference's ``model.init_params`` tree (numpy leaves) as the
    port's parameter dict.  Only dense stacks (one ``scan0`` group of
    ``cfg.num_layers`` layers) are ported."""
    stack = tree["stack"]
    if set(stack) != {"scan0"} or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only dense stacks are ported (ROADMAP Queue 1 "
            "item 9: the other model families)")
    conv = lambda a: tensor_from_numpy(a, device, dtype)  # noqa: E731
    scan = stack["scan0"]
    return {
        "embed": _tree(tree["embed"], conv),
        "layers": [_tree(scan, lambda a, i=i: conv(np.asarray(a)[i]))
                   for i in range(cfg.num_layers)],
        "final_ln": conv(tree["final_ln"]),
    }


def predictor_from_numpy(layers: Sequence[dict], mean, std,
                         device) -> predictor_lib.Predictor:
    """A trained reference m_theta (its ``params`` list of ``{"w", "b"}``
    numpy leaves plus the feature ``mean``/``std``) as the port's
    predictor on ``device``."""
    params = [{k: tensor_from_numpy(layer[k], device, torch.float32)
               for k in ("w", "b")} for layer in layers]
    return predictor_lib.Predictor(params=params, mean=np.asarray(mean),
                                   std=np.asarray(std), train_losses=[])
