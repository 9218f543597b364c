"""Seeded random weights, made by the benchmark and handed to both sides.

The tree has the layout the port's model functions read (the reference's
``init_params`` layout: ``embed``/``layers``/``final_ln``, per-layer
``ln1``/``attn``/``ln2`` and ``mlp`` or ``moe``), at the reference's init
scales (dense 0.02, embedding 1/sqrt(D), norms zero; the MoE router in
float32) unless the configuration's ``init`` sets others.  Every leaf of one dtype is a view of one flat buffer, filled by
a few large ``normal_`` calls from a ``torch.Generator`` on the weights'
device: on the card that is about 20 calls for kimi-k2-2l's 40 GB.  The
same tensors go to the program and, read only, to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# elements drawn by one normal_ call
_DRAW = 1 << 30
_NORMS = ("ln1", "ln2", "final_ln")


def padded_vocab(model: dict) -> int:
    """The vocabulary padded to a multiple of 2048, as the port's
    ``ModelConfig.padded_vocab`` (the logits past ``vocab_size`` are
    masked)."""
    return -(-model["vocab_size"] // 2048) * 2048


def layer_kinds(model: dict) -> List[str]:
    if model["family"] == "moe":
        k = model["num_dense_layers"]
        return ["dense"] * k + ["moe"] * (model["num_layers"] - k)
    if model["family"] == "dense":
        return ["dense"] * model["num_layers"]
    raise ValueError(f"family {model['family']!r} has no layout here")


def layout(model: dict) -> Dict[str, object]:
    """The tree of (shape, dtype-name) leaves."""
    D, H, KV, hd = (model["d_model"], model["num_heads"],
                    model["num_kv_heads"], model["head_dim"])
    dt = model["param_dtype"]
    V = padded_vocab(model)

    def mlp(F, act):
        p = {"w_up": ((D, F), dt), "w_down": ((F, D), dt)}
        if act == "swiglu":
            p["w_gate"] = ((D, F), dt)
        return p

    embed = {"embedding": ((V, D), dt)}
    if not model["tie_embeddings"]:
        embed["lm_head"] = ((D, V), dt)
    layers = []
    for kind in layer_kinds(model):
        p = {"ln1": ((D,), dt),
             "attn": {"wq": ((D, H, hd), dt), "wk": ((D, KV, hd), dt),
                      "wv": ((D, KV, hd), dt), "wo": ((H, hd, D), dt)},
             "ln2": ((D,), dt)}
        if kind == "moe":
            E, Fe = model["num_experts"], model["moe_d_ff"]
            p["moe"] = {"router": ((D, E), "float32"),
                        "w_gate": ((E, D, Fe), dt), "w_up": ((E, D, Fe), dt),
                        "w_down": ((E, Fe, D), dt)}
            if model.get("num_shared_experts"):
                p["moe"]["shared"] = mlp(Fe * model["num_shared_experts"],
                                         "swiglu")
        else:
            p["mlp"] = mlp(model["d_ff"], model["mlp_act"])
        layers.append(p)
    return {"embed": embed, "layers": layers, "final_ln": ((D,), dt)}


def _leaves(tree, path=()) -> List[Tuple[tuple, tuple, str]]:
    if isinstance(tree, tuple):
        return [(path, tree[0], tree[1])]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = []
    for k, v in items:
        out += _leaves(v, path + (k,))
    return out


def _scale(path: tuple, model: dict, init: dict) -> float:
    if path[-1] in _NORMS:
        return 0.0
    if path[-1] == "embedding":
        return init.get("embedding_std", 1.0 / math.sqrt(model["d_model"]))
    return init.get("std", 0.02)


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def make(model: dict, seed: int, device, init: dict = None) -> dict:
    """The weights for ``seed`` on ``device``; ``init`` may set the
    standard deviations ``std`` (every product's weight) and
    ``embedding_std`` in place of the defaults."""
    init = init or {}
    tree = layout(model)
    leaves = _leaves(tree)
    gen = torch.Generator(device=device).manual_seed(seed)
    for dtype_name in sorted({d for _, _, d in leaves}):
        dtype = getattr(torch, dtype_name)
        mine = [(p, s) for p, s, d in leaves if d == dtype_name]
        total = sum(math.prod(s) for _, s in mine)
        flat = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, _DRAW):
            flat[lo:lo + _DRAW].normal_(generator=gen)
        off = 0
        for path, shape in mine:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            off += n
            s = _scale(path, model, init)
            if s == 0.0:
                leaf.zero_()
            else:
                leaf.mul_(s)
            _put(tree, path, leaf)
    return tree


def nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(nbytes(v) for v in items)
