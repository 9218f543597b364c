"""Checkpoints (PyTorch port of ``repro.training.checkpoint``), in the
reference's on-disk format: the tree flattened to ``/``-joined paths
(list items by index), the leaves in ``shard%05d.npz`` files of at most
about ``shard_bytes`` each, and ``manifest.json`` naming each leaf's
shard, dtype and array name.  bf16 leaves are stored as their ``uint16``
bit patterns.  A checkpoint either package writes, the other reads:
``restore(path)`` with no ``like`` returns the stored tree as nested
dicts of CPU tensors, which ``models.convert.params_from_numpy`` lays out
as the port's parameters when the reference wrote it.

A tree of DTensors (a sharded run) is saved in the same format: every
rank gathers each leaf (``full_tensor()``, a collective, so every rank
calls ``save``) and rank 0 writes the files, which an unsharded run
restores.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..sharding import local as shlocal
from ..tree import tree_map_with_path, tree_paths

_KEY_SEP = "/"


def _flatten(tree) -> dict:
    return {_KEY_SEP.join(map(str, path)): leaf
            for path, leaf in tree_paths(tree)}


def _to_numpy(leaf) -> tuple:
    """(array, manifest dtype) of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str, tree: Any, *, step: int = 0,
         shard_bytes: int = 1 << 30) -> None:
    flat = _flatten(tree)
    if any(shlocal.is_dtensor(v) for v in flat.values()):
        flat = {k: v.full_tensor() if shlocal.is_dtensor(v) else v
                for k, v in flat.items()}
        if dist.get_rank() != 0:
            return
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "keys": {}}
    shard, shard_idx, shard_sz = {}, 0, 0

    def flush():
        nonlocal shard, shard_idx, shard_sz
        if shard:
            np.savez(os.path.join(path, f"shard{shard_idx:05d}.npz"),
                     **shard)
            shard, shard_sz = {}, 0
            shard_idx += 1

    for key, leaf in sorted(flat.items()):
        arr, dtype = _to_numpy(leaf)
        safe = re.sub(r"[^\w/.-]", "_", key)
        manifest["keys"][key] = {"shard": shard_idx, "dtype": dtype,
                                 "name": safe}
        shard[safe] = arr
        shard_sz += arr.nbytes
        if shard_sz >= shard_bytes:
            flush()
    flush()
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def restore(path: str, like: Optional[Any] = None) -> tuple:
    """Returns (tree, step).  ``like`` supplies the structure (dicts and
    lists) and each leaf's device, and must name exactly the stored
    leaves (``ValueError`` otherwise); the dtypes are the stored ones.
    Without ``like``: nested dicts of CPU tensors, as stored."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards = {}

    def load(meta) -> torch.Tensor:
        i = meta["shard"]
        if i not in shards:
            shards[i] = np.load(os.path.join(path, f"shard{i:05d}.npz"))
        return _to_tensor(shards[i][meta["name"]], meta["dtype"])

    if like is None:
        tree: dict = {}
        for key, meta in manifest["keys"].items():
            *head, last = key.split(_KEY_SEP)
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[last] = load(meta)
        return tree, manifest["step"]

    flat_like = _flatten(like)
    missing = set(flat_like) - set(manifest["keys"])
    extra = set(manifest["keys"]) - set(flat_like)
    if missing or extra:
        raise ValueError(
            f"checkpoint mismatch: missing={sorted(missing)[:5]} "
            f"extra={sorted(extra)[:5]}")

    def leaf(node, path):
        t = load(manifest["keys"][_KEY_SEP.join(map(str, path))])
        return t.to(node.device) if isinstance(node, torch.Tensor) else t

    return tree_map_with_path(leaf, like), manifest["step"]
