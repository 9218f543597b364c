"""Logical-axis sharding policy with divisibility fallbacks (PyTorch port of
``repro.sharding.policy``), over a ``torch.distributed`` ``DeviceMesh``.

Mesh layout (``launch/mesh.py``):
    single pod : (16, 16)      axes ("data", "model")
    multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")

Logical axes used by the models:
    batch      -> sharded over ("pod", "data") greedily (B=1 stays replicated)
    fsdp       -> parameter d_model/reduction dims over ("data", "pod")
    heads      -> q heads over "model" (falls back to replicate: 24-head
                  archs like minitron/starcoder2 do not divide 16)
    kv_heads   -> kv heads over "model" (kv=8 archs fall back to replicate;
                  the KV *cache* instead shards its sequence dim, below)
    vocab      -> padded vocab over "model"
    experts    -> MoE expert dim over "model" (mixtral's 8 experts fall back
                  to sharding the expert d_ff instead)
    mlp        -> d_ff over "model"
    model      -> generic model-parallel dim (ssm heads, lru width, ...)

KV caches prefer kv_heads -> "model"; when kv does not divide the axis they
shard the sequence dim over "model" instead.

The resolution rules (``resolve``, ``spec``, ``moe_axes``,
``attn_q_axes``, ``use_seq_attention``, ``_param_axes``,
``_cache_leaf_axes`` and the Adafactor statistics' derivation) are the
reference's, decision for decision.  A spec is a tuple with one entry a
tensor dim: ``None``, a mesh-axis name, or a tuple of names (a mesh axis
shards at most one dim).  The policy reads the mesh only as its axis
names and sizes, so a shape-only stand-in with ``shape`` (a dict) and
``axis_names`` serves the pure rules.

The port's parameter and cache trees hold one entry a layer (no stacked
layer dim), so ``param_shardings`` / ``cache_shardings`` give each leaf
the reference's axes without the leading ``None`` the reference adds for
a stacked dim; the Adafactor statistics keep the reference's stacked
groups (``optimizer.reference_groups``) and so their leading dim.

The DTensor side: ``placements(spec)`` lists one ``Shard(d)`` or
``Replicate()`` a mesh dim, ``distribute`` lays a tree out as DTensors by
its specs, and ``constrain`` redistributes a DTensor (GSPMD's
``with_sharding_constraint``).  When two mesh axes shard one dim, DTensor
splits it with the first mesh dim outermost, where the reference's spec
order decides; the values are the same, only which rank holds which slice
differs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional, Sequence, Tuple

import torch

from ..tree import tree_map_with_path

_SCOPE = {"lock": threading.Lock(), "depth": 0}

# preference lists: logical axis -> candidate mesh axes (greedy prefix)
_PREFS = {
    "batch": ("pod", "data"),
    "fsdp": ("data", "pod"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "mlp": ("model",),
    "model": ("model",),
    "seq": ("model",),          # sequence parallelism (opt-in flag)
    "expert_ff": ("data", "pod"),  # serving layout: expert d_ff over data
    "kv_seq": ("model",),       # decode-cache sequence dim (ungated: the
                                # cache itself is stored this way whenever
                                # kv heads don't divide the model axis)
}


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a shape-only stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _names(path) -> tuple:
    """The dict keys of a tree path (list indices dropped), as the
    reference's ``DictKey`` filter."""
    return tuple(p for p in path if isinstance(p, str))


@dataclasses.dataclass
class ShardingPolicy:
    mesh: Any
    # fsdp=False turns off parameter sharding over the data axes (pure DP
    # + TP)
    fsdp: bool = True
    # seq_parallel: shard the residual stream's sequence dim over "model"
    # between blocks; also enables sequence-sharded attention for archs
    # whose head count does not divide the model axis
    seq_parallel: bool = False
    # serving: weight layout for prefill/decode — expert d_ff sharded over
    # the data axes instead of ZeRO-style d_model sharding, so decode
    # never gathers expert weights (it token-replicates instead); combine
    # with fsdp=False for dense params
    serving: bool = False

    @property
    def axes(self) -> dict:
        return mesh_axes(self.mesh)

    @contextlib.contextmanager
    def scope(self):
        """DTensor's implicit replication while the policy is active: the
        plain tensors model code makes (positions, masks, zeros) join
        DTensor ops as replicated.  Entered by ``context.use_policy``.
        DTensor keeps the switch for the whole process, so the scopes are
        counted across threads (autograd recomputes a rematerialised layer
        on its own thread, inside the forward's scope) and the switch goes
        off when the last one ends."""
        with _SCOPE["lock"]:
            if _SCOPE["depth"] == 0:
                from torch.distributed.tensor.experimental import (
                    implicit_replication)
                _SCOPE["cm"] = implicit_replication()
                _SCOPE["cm"].__enter__()
            _SCOPE["depth"] += 1
        try:
            yield
        finally:
            with _SCOPE["lock"]:
                _SCOPE["depth"] -= 1
                if _SCOPE["depth"] == 0:
                    _SCOPE.pop("cm").__exit__(None, None, None)

    # ------------------------------------------------------------------
    def resolve(self, dim: int, logical: Optional[str]):
        """Greedy prefix of the preference list whose product divides dim."""
        if logical is None:
            return None
        if not self.fsdp and logical == "fsdp":
            return None
        if not self.seq_parallel and logical == "seq":
            return None
        sizes = self.axes
        chosen = []
        prod = 1
        for ax in _PREFS[logical]:
            if ax not in sizes:
                continue
            size = sizes[ax]
            if size == 1:
                continue  # size-1 axes add nothing; keep specs clean
            if dim % (prod * size) == 0:
                chosen.append(ax)
                prod *= size
        if not chosen:
            return None
        return chosen[0] if len(chosen) == 1 else tuple(chosen)

    def spec(self, shape: Sequence[int],
             axes: Sequence[Optional[str]]) -> tuple:
        assert len(shape) == len(axes), (shape, axes)
        resolved = [self.resolve(d, a) for d, a in zip(shape, axes)]
        # drop duplicate mesh-axis usage (a mesh axis may shard one dim only)
        used = set()
        out = []
        for r in resolved:
            if r is None:
                out.append(None)
                continue
            rt = (r,) if isinstance(r, str) else tuple(r)
            rt = tuple(a for a in rt if a not in used)
            used.update(rt)
            if not rt:
                out.append(None)
            elif len(rt) == 1:
                out.append(rt[0])
            else:
                out.append(rt)
        return tuple(out)

    # ------------------------------------------------------------------
    # DTensor side
    # ------------------------------------------------------------------
    def placements(self, spec: Sequence) -> list:
        """One placement a mesh dim: ``Shard(d)`` where the mesh axis
        shards tensor dim d in ``spec``, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        owner = {}
        for d, entry in enumerate(spec):
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                owner[a] = d
        return [Shard(owner[a]) if a in owner else Replicate()
                for a in self.axes]

    def distribute_one(self, x: torch.Tensor, spec: Sequence):
        """``x`` (the same full tensor on every rank) as a DTensor laid out
        by ``spec``: each rank keeps a copy of its slice, nothing is
        sent."""
        from torch.distributed.tensor import DTensor
        pl = self.placements(spec)
        coord = self.mesh.get_coordinate()
        t = x
        for m, p in enumerate(pl):
            if p.is_shard():
                n = t.shape[p.dim] // self.mesh.size(m)
                t = t.narrow(p.dim, coord[m] * n, n)
        return DTensor.from_local(t.clone() if t is not x else t,
                                  self.mesh, pl, run_check=False)

    def distribute(self, tree, shardings):
        """``tree`` laid out as DTensors by the matching tree of specs
        (``param_shardings``, ``cache_shardings``, ``opt_shardings``,
        ``batch_shardings``).  Non-tensor leaves pass through."""
        flat = dict(_flat(shardings))

        def one(leaf, path):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return self.distribute_one(leaf, flat[path])
        return tree_map_with_path(one, tree)

    def constrain(self, x, axes):
        """``x`` redistributed to ``spec(x.shape, axes)``; a plain tensor
        (the same on every rank) is first taken as replicated."""
        from torch.distributed.tensor import DTensor, Replicate
        want = self.placements(self.spec(tuple(x.shape), axes))
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * len(want),
                                   run_check=False)
        if list(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    # ------------------------------------------------------------------
    # perf-iteration layout helpers
    # ------------------------------------------------------------------
    def moe_axes(self, which: str):
        """Expert-weight logical axes. which: 'gate_up' | 'down'.

        Train layout: ZeRO-style d_model sharding over data ("fsdp").
        Serving layout: d_ff over data ("expert_ff") so decode can
        token-replicate instead of gathering weights per layer.
        """
        if self.serving:
            return (("experts", None, "expert_ff") if which == "gate_up"
                    else ("experts", "expert_ff", None))
        return (("experts", "fsdp", "mlp") if which == "gate_up"
                else ("experts", "mlp", "fsdp"))

    def attn_q_axes(self, seq_len: int, num_heads: int):
        """Query activation sharding: heads when divisible; else the
        sequence dim under seq_parallel."""
        if self.resolve(num_heads, "heads") is not None:
            return ("batch", None, "heads", None)
        if self.seq_parallel and self.resolve(seq_len, "seq") is not None:
            return ("batch", "seq", None, None)
        return ("batch", None, None, None)

    def use_seq_attention(self, seq_len: int, num_heads: int) -> bool:
        return (self.resolve(num_heads, "heads") is None
                and self.seq_parallel
                and self.resolve(seq_len, "seq") is not None)

    # ------------------------------------------------------------------
    # parameter shardings (path-pattern rules over the params tree)
    # ------------------------------------------------------------------
    def _param_axes(self, path: Tuple[str, ...],
                    ndim: int) -> Tuple[Optional[str], ...]:
        """Logical axes for a parameter leaf, by its tree path."""
        name = path[-1]
        under_moe = "moe" in path
        under_shared = "shared" in path

        if name == "embedding":
            return ("vocab", None)
        if name == "lm_head":
            return (None, "vocab")
        if name in ("wq",):
            return ("fsdp", "heads", None)
        if name in ("wk", "wv"):
            return ("fsdp", "kv_heads", None)
        if name == "wo":
            return ("heads", None, "fsdp")
        if name == "router":
            return (None, "experts")
        if under_moe and not under_shared:
            if name in ("w_gate", "w_up"):      # (E, D, F)
                return self.moe_axes("gate_up")
            if name == "w_down":                # (E, F, D)
                return self.moe_axes("down")
        if name in ("w_gate", "w_up"):           # dense mlp (D, F)
            return ("fsdp", "mlp")
        if name == "w_down":                     # (F, D)
            return ("mlp", "fsdp")
        # --- ssm (mamba2) ---
        if name == "in_proj":                    # (D, X) X has mixed slices
            return ("fsdp", None)
        if name == "out_proj":                   # (di, D)
            return ("model", "fsdp")
        if name == "conv_w":                     # (W, C)
            return (None, "model")
        if name in ("conv_b", "norm"):
            return ("model",)
        if name in ("A_log", "dt_bias", "D"):
            return ("model",)
        # --- rglru ---
        if name in ("w_x", "w_gate_branch"):     # (D, lw)
            return ("fsdp", "model")
        if name in ("w_a", "w_i"):               # (lw, lw)
            return (None, "model")
        if name in ("b_a", "b_i", "Lambda"):
            return ("model",)
        if name == "w_out":                      # (lw, D)
            return ("model", "fsdp")
        # --- projector / everything else (norms, scalars) ---
        if name in ("w1", "w2"):                 # (D, D)
            return ("fsdp", None)
        return (None,) * ndim

    def param_axes(self, path, ndim: int) -> tuple:
        """A parameter leaf's logical axes (replicated where the rule's
        rank differs from the leaf's)."""
        axes = self._param_axes(_names(path), ndim)
        return tuple(axes) if len(axes) == ndim else (None,) * ndim

    def gather_fsdp(self, tree, prefix: tuple = ()):
        """The parameters of ``tree`` (at path ``prefix`` in the parameter
        tree) with their "fsdp" dims gathered: ZeRO-3's per-layer
        all-gather before use (its backward reduce-scatters the
        gradients), as GSPMD inserts it inside the reference's scan.
        Tensors that are not DTensors pass through."""
        from torch.distributed.tensor import DTensor

        def one(leaf, path):
            if not isinstance(leaf, DTensor):
                return leaf
            axes = tuple(None if a == "fsdp" else a for a in
                         self.param_axes(prefix + path, leaf.ndim))
            want = self.placements(self.spec(tuple(leaf.shape), axes))
            if list(leaf.placements) == want:
                return leaf
            return leaf.redistribute(self.mesh, want)
        return tree_map_with_path(one, tree)

    def param_shardings(self, params):
        """The spec of every leaf of the port's parameter tree."""
        return tree_map_with_path(
            lambda leaf, path: self.spec(
                tuple(leaf.shape), self.param_axes(path, leaf.ndim)),
            params)

    # ------------------------------------------------------------------
    # input / cache shardings
    # ------------------------------------------------------------------
    def batch_shardings(self, batch_example):
        """Specs for a train/prefill batch: dim0 = global batch."""
        return tree_map_with_path(
            lambda leaf, _: self.spec(
                tuple(leaf.shape), ("batch",) + (None,) * (leaf.ndim - 1)),
            batch_example)

    def _cache_leaf_axes(self, path, shape):
        name = path[-1]
        if name in ("pos", "slot_pos"):
            return (None,) * len(shape)
        # strip the stacked-layer dim for scanned caches
        scanned = any(n.startswith("scan") for n in path)
        core = shape[1:] if scanned else shape
        if name in ("k", "v", "enc_k", "enc_v"):
            # (B, S, KV, hd): kv heads if divisible, else sequence
            kv_ok = self.resolve(core[2], "kv_heads") is not None
            axes = ("batch", None, "kv_heads", None) if kv_ok else \
                ("batch", "model", None, None)
        elif name == "conv":
            axes = ("batch", None, "model")
        elif name == "ssd":
            axes = ("batch", "model", None, None)
        elif name == "h":
            axes = ("batch", "model")
        else:
            axes = (None,) * len(core)
        if scanned:
            axes = (None,) + tuple(axes)
        return axes

    def cache_shardings(self, cache_example):
        return tree_map_with_path(
            lambda leaf, path: self.spec(
                tuple(leaf.shape),
                self._cache_leaf_axes(_names(path), tuple(leaf.shape))),
            cache_example)

    def opt_shardings(self, opt_state_example):
        """Specs for optimizer state trees.

        AdamW moments ("mu"/"nu" subtrees) mirror the parameter specs
        (paths end with the same leaf names).  Adafactor factored stats
        ("stats"/<reference leaf path>/{r,c,v}, stacked for a scanned
        group) derive from the parameter's axes: r drops the last dim, c
        drops the second-to-last, v mirrors.
        """
        def one(leaf, path):
            names = _names(path)
            if names[0] == "stats":     # keyed by the reference's path
                names = (names[0],) + tuple(names[1].split("/")) + \
                    names[2:]
            if names[-1] in ("step",):
                return (None,) * leaf.ndim
            if names[-1] in ("r", "c", "v"):
                scanned = any(n.startswith("scan") for n in names) or \
                    "blocks" in names
                pnames = names[1:-1]
                trailing = leaf.ndim - (1 if scanned else 0)
                # parameter trailing ndim: r -> +1, c -> +1, v -> +0
                p_nd = trailing + (1 if names[-1] in ("r", "c") else 0)
                axes = self._param_axes(pnames, p_nd)
                if len(axes) != p_nd:
                    axes = (None,) * p_nd
                if names[-1] == "r":
                    axes = axes[:-1]
                elif names[-1] == "c":
                    axes = axes[:-2] + axes[-1:]
                if scanned:
                    axes = (None,) + tuple(axes)
            else:
                axes = self.param_axes(names[1:], leaf.ndim)
            return self.spec(tuple(leaf.shape), axes)

        return tree_map_with_path(one, opt_state_example)


def _flat(tree, prefix: tuple = ()):
    """(path, spec) pairs of a tree of specs (a spec is a tuple leaf)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _flat(v, prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in _flat(v, prefix + (i,))]
    return [(prefix, tree)]


def make_policy(mesh, fsdp: bool = True) -> ShardingPolicy:
    return ShardingPolicy(mesh=mesh, fsdp=fsdp)
