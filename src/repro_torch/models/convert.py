"""Weight bridge: the JAX package's parameter trees, as numpy, into the port.

The port keeps the reference's tensor layouts (``wq (D, H, hd)``,
``wo (H, hd, D)``, ``embedding (V, D)``, MoE ``w_gate (E, D, F)``, ...),
so the bridge is a copy: it lays the reference's ``stack`` groups
(``prefix{i}``, the scanned ``scan{s}`` groups unstacked along their
leading layer axis, ``tail{i}``) out as the port's per-layer list in the
order of ``transformer.layer_kinds``, and converts every leaf, bit for bit
(bf16 leaves travel through their raw 16-bit pattern, since numpy has no
bf16 that torch reads).  The encdec encoder's vmapped ``blocks`` become a
list the same way, and ``frontend_proj`` and the ``cross`` layers' leaves
are copied as they are.  Nothing here imports JAX: callers hand over
``jax.tree.map(np.asarray, params)``, or the tree that
``training.checkpoint.restore`` reads from a checkpoint the reference
wrote (torch leaves).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import predictor as predictor_lib
from ..tree import tree_map_with_path
from . import transformer


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """One numpy (or torch) leaf to a tensor on ``device``; a bf16 leaf
    (ml_dtypes) keeps its exact bits.  ``dtype`` casts after the exact
    copy."""
    if isinstance(a, torch.Tensor):
        t = a.to(device)
        return t if dtype is None else t.to(dtype)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _row(a, r):
    """Row ``r`` of a stacked leaf (numpy, JAX or torch)."""
    return a[r] if isinstance(a, torch.Tensor) else np.asarray(a)[r]


def unstack(tree, n: int) -> list:
    """A vmapped tree of leading axis ``n`` as ``n`` trees."""
    return [tree_map_with_path(lambda a, _, r=r: _row(a, r), tree)
            for r in range(n)]


def layer_groups(cfg) -> list:
    """The reference's stack groups over the port's flat layer list:
    ``(name, layer indices, stacked)`` for ``prefix{i}`` (one layer, no
    layer axis), each ``scan{s}`` (the layers of repeat-group ``s``, kept
    stacked along a leading axis) and ``tail{i}``, as ``stack_layers``
    lays them out."""
    pat, n, prefix, tail = transformer.stack_pattern(cfg)
    groups = [(f"prefix{i}", [i], False) for i in range(len(prefix))]
    base = len(prefix)
    groups += [(f"scan{s}", [base + r * len(pat) + s for r in range(n)],
                True) for s in range(len(pat)) if n > 0]
    base += n * len(pat)
    return groups + [(f"tail{i}", [base + i], False)
                     for i in range(len(tail))]


def stack_layers(stack: dict, cfg) -> list:
    """The reference's ``stack`` tree (numpy, JAX or torch leaves) as one
    tree a layer, in the port's layer order: ``prefix{i}``, then the
    layers of the scanned groups (layer ``r`` of repeat-group ``s`` is
    ``scan{s}[...][r]``, repeats outer), then ``tail{i}``."""
    out = [None] * cfg.num_layers
    for name, idx, stacked in layer_groups(cfg):
        rows = unstack(stack[name], len(idx)) if stacked else [stack[name]]
        for i, row in zip(idx, rows):
            out[i] = row
    return out


#: the leaves the reference keeps in float32 whatever the parameter dtype:
#: MoE routers, the SSD mixers' decay and skip (ssm.py:34-55) and the
#: RG-LRU's gate biases and decay (rglru.py:25-44)
FLOAT32_LEAVES = frozenset({"router", "A_log", "dt_bias", "D", "b_a", "b_i",
                            "Lambda"})


def params_from_numpy(tree: dict, cfg, device, dtype=None) -> dict:
    """The reference's ``model.init_params`` tree (numpy leaves) as the
    port's parameter dict.  ``dtype`` casts every leaf but
    ``FLOAT32_LEAVES``, which stay float32 as the reference keeps them."""
    def conv(a, path):
        keep = bool(path) and path[-1] in FLOAT32_LEAVES
        return tensor_from_numpy(a, device, None if keep else dtype)

    out = {
        "embed": tree_map_with_path(conv, tree["embed"]),
        "layers": [tree_map_with_path(conv, layer)
                   for layer in stack_layers(tree["stack"], cfg)],
        "final_ln": conv(tree["final_ln"], ()),
    }
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "blocks": [tree_map_with_path(conv, b) for b in
                       unstack(enc["blocks"], cfg.num_encoder_layers)],
            "final_ln": conv(enc["final_ln"], ())}
    if "frontend_proj" in tree:
        out["frontend_proj"] = tree_map_with_path(conv,
                                                  tree["frontend_proj"])
    return out


def predictor_from_numpy(layers: Sequence[dict], mean, std,
                         device) -> predictor_lib.Predictor:
    """A trained reference m_theta (its ``params`` list of ``{"w", "b"}``
    numpy leaves plus the feature ``mean``/``std``) as the port's
    predictor on ``device``."""
    params = [{k: tensor_from_numpy(layer[k], device, torch.float32)
               for k in ("w", "b")} for layer in layers]
    return predictor_lib.Predictor(params=params, mean=np.asarray(mean),
                                   std=np.asarray(std), train_losses=[])
