"""Weight bridge: the JAX package's parameter trees, as numpy, into the port.

The port keeps the reference's tensor layouts (``wq (D, H, hd)``,
``wo (H, hd, D)``, ``embedding (V, D)``, MoE ``w_gate (E, D, F)``, ...),
so the bridge is a copy: it lays the reference's ``stack`` groups
(``prefix{i}``, the scanned ``scan{s}`` groups unstacked along their
leading layer axis, ``tail{i}``) out as the port's per-layer list in the
order of ``transformer.layer_kinds``, and converts every leaf, bit for bit
(bf16 leaves travel through their raw 16-bit pattern, since numpy has no
bf16 that torch reads).  Nothing here imports JAX: callers hand over
``jax.tree.map(np.asarray, params)``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import predictor as predictor_lib
from . import transformer


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


def _tree(x, fn, path=()):
    if isinstance(x, dict):
        return {k: _tree(v, fn, path + (k,)) for k, v in x.items()}
    return fn(x, path)


def stack_layers(stack: dict, cfg) -> list:
    """The reference's ``stack`` tree (numpy or JAX leaves) as one tree a
    layer, in the port's layer order: ``prefix{i}``, then the layers of
    the scanned groups (layer ``r`` of repeat-group ``s`` is
    ``scan{s}[...][r]``, repeats outer), then ``tail{i}``."""
    pat, n, prefix, tail = transformer.stack_pattern(cfg)
    out = [stack[f"prefix{i}"] for i in range(len(prefix))]
    for r in range(n):
        for s in range(len(pat)):
            out.append(_tree(stack[f"scan{s}"],
                             lambda a, _, r=r: np.asarray(a)[r]))
    return out + [stack[f"tail{i}"] for i in range(len(tail))]


#: the leaves the reference keeps in float32 whatever the parameter dtype:
#: MoE routers, the SSD mixers' decay and skip (ssm.py:34-55) and the
#: RG-LRU's gate biases and decay (rglru.py:25-44)
FLOAT32_LEAVES = frozenset({"router", "A_log", "dt_bias", "D", "b_a", "b_i",
                            "Lambda"})


def params_from_numpy(tree: dict, cfg, device, dtype=None) -> dict:
    """The reference's ``model.init_params`` tree (numpy leaves) as the
    port's parameter dict.  ``dtype`` casts every leaf but
    ``FLOAT32_LEAVES``, which stay float32 as the reference keeps them."""
    transformer.check_ported(cfg)

    def conv(a, path):
        keep = bool(path) and path[-1] in FLOAT32_LEAVES
        return tensor_from_numpy(a, device, None if keep else dtype)

    return {
        "embed": _tree(tree["embed"], conv),
        "layers": [_tree(layer, conv)
                   for layer in stack_layers(tree["stack"], cfg)],
        "final_ln": conv(tree["final_ln"], ()),
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
