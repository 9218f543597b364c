"""Per-rank cost model of an eager PyTorch step: the port's counterpart of
``repro.launch.hlo_cost`` (the port has no HLO to parse, as
``kernels/rms_norm.py`` stands for the reference's ``rmsnorm.py``).

``OpCost`` is a ``TorchDispatchMode``.  Run a step inside it (on real
tensors, or on the fake tensors of ``launch.specs`` for a dry run) and it
accumulates what every aten op the step dispatches costs ONE rank:

  flops            — ``torch.utils.flop_counter``'s registered formulas
                     (``mm``, ``bmm``, ``addmm``, convolutions, attention
                     ops) applied to the op's operand shapes;
  hbm traffic      — operand bytes + result bytes of every op that
                     launches a kernel.  Eager PyTorch fuses nothing, so
                     every op is a kernel boundary, except the views and
                     metadata ops (``view``, ``_unsafe_view``, ``t``,
                     ``transpose``, ``expand``, ``slice``, ``select``,
                     ``as_strided``, ``detach``, ``alias`` and every other
                     op whose schema marks its result a view), the
                     allocations that write nothing (``empty*``), the
                     ``prim`` metadata ops and the collectives' ``wait``
                     (the reference's ``_TRAFFIC_OPS`` leaves out
                     ``convert`` and ``copy`` in the same spirit: what
                     moves no data on the device is not traffic);
  collective bytes — result-shape bytes by kind (all-reduce, all-gather,
                     reduce-scatter, all-to-all, collective-permute: the
                     reference's kinds and its convention,
                     ``repro.launch.analysis.collective_stats``), for the
                     ``_c10d_functional`` and ``_dtensor`` ops DTensor's
                     redistributions issue and for the explicit
                     ``torch.distributed`` calls (``sharding/local.py``,
                     ``moe.apply_moe_ep``), which reach the dispatcher as
                     ``c10d`` ops.  Point to point sends and broadcasts
                     count as collective-permute.  Collectives count as
                     traffic too, as in the reference.

Per rank, as the reference's post-SPMD module is: an op on DTensors is
not counted at the DTensor level (its global shapes would count the whole
mesh's work); the mode returns ``NotImplemented`` so that DTensor
desugars it into ops on its local shards (and the collectives of any
redistribution it needs), which then reach the mode and are counted.
DTensor's sharding propagation runs the op once more on global-shape
fake tensors to learn its output's metadata, and a strided shard's
offsets are computed with torch ops on the host; while an ``OpCost`` is
active both run with every dispatch mode suspended (``_HOST_PLANNING``),
so they are neither counted nor seen by a ``MemTracker``, nor faked.

The reference needs trip counts because XLA's ``cost_analysis`` counts a
``while`` body once.  The port has no such problem: its layers are a
Python loop that dispatches every layer's ops, and the recompute of
``torch.utils.checkpoint`` (remat) dispatches its ops again in the
backward pass, so each op is counted as often as it runs.

``breakdown=True`` also keys every count by the chain of the port's
functions on the Python stack at the op (``model.lm_loss/
transformer.apply_stack/layers.chunked_attention``), the counterpart of
the reference's per-``op_name`` breakdown.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

_COLLECTIVES = {
    "_c10d_functional": {
        "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
        "all_reduce_coalesced": "all-reduce",
        "all_reduce_coalesced_": "all-reduce",
        "all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_out": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all",
        "broadcast": "collective-permute", "broadcast_": "collective-permute",
    },
    # DTensor's Shard(i) -> Shard(j) on a CUDA mesh
    "_dtensor": {"shard_dim_alltoall": "all-to-all"},
    "c10d": {
        "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
        "allgather_": "all-gather", "_allgather_base_": "all-gather",
        "allgather_coalesced_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "reduce_scatter_": "reduce-scatter",
        "_reduce_scatter_base_": "reduce-scatter",
        "reduce_scatter_tensor_coalesced_": "reduce-scatter",
        "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
        "broadcast_": "collective-permute", "send": "collective-permute",
        "recv_": "collective-permute",
    },
}

# ops that launch no kernel and move no data (views are caught by schema)
_NO_TRAFFIC = frozenset({
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "wait_tensor", "_local_scalar_dense",
    "resize_", "set_", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_same_storage_numel"})


def _tensors(x):
    """The tensors of a (nested) argument or result."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a collective op, or None."""
    return _COLLECTIVES.get(func.namespace, {}).get(
        func._overloadpacket.__name__)


def _moves_data(func) -> bool:
    if func.namespace == "prim" or func.is_view:
        return False
    return func._overloadpacket.__name__ not in _NO_TRAFFIC


# ---------------------------------------------------------------------------
# DTensor's host-side planning, outside every mode
# ---------------------------------------------------------------------------

#: DTensor functions (module, class or None, name) that compute metadata
#: with torch ops on the host: the output-metadata propagation (the op run
#: once on global-shape fake tensors) and the shard offsets (``arange`` +
#: ``tolist`` / ``int``, which a fake mode cannot answer)
_HOST_PLANNING = (
    ("torch.distributed.tensor._sharding_prop", "ShardingPropagator",
     "_propagate_tensor_meta_non_cached"),
    ("torch.distributed.tensor.placement_types", "_StridedShard",
     "local_shard_size_and_offset"),
    ("torch.distributed.tensor._utils", None,
     "_compute_local_shape_and_global_offset"),
)
_PLANNING = {"lock": threading.Lock(), "depth": 0, "saved": []}


def _outside_modes(fn):
    def run(*args, **kwargs):
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


def _isolate_planning(on: bool) -> None:
    """While any ``OpCost`` is active, the functions of ``_HOST_PLANNING``
    run with the dispatch modes suspended (counted across nested modes).
    Raises if this torch lacks one of them."""
    import importlib
    with _PLANNING["lock"]:
        if on:
            if _PLANNING["depth"] == 0:
                found = []
                for mod, cls, name in _HOST_PLANNING:
                    owner = importlib.import_module(mod)
                    if cls is not None:
                        owner = getattr(owner, cls, None)
                    raw = vars(owner).get(name) if owner else None
                    if raw is None:
                        # without it DTensor's planning would be counted
                        # on global shapes: fail rather than miscount
                        raise RuntimeError(
                            f"op_cost: {mod}.{cls + '.' if cls else ''}"
                            f"{name} is not in torch {torch.__version__}; "
                            f"update _HOST_PLANNING")
                    found.append((owner, name, raw))
                for owner, name, raw in found:
                    kind = type(raw) if isinstance(
                        raw, (staticmethod, classmethod)) else None
                    fn = _outside_modes(raw.__func__ if kind else raw)
                    setattr(owner, name, kind(fn) if kind else fn)
                _PLANNING["saved"] = found
            _PLANNING["depth"] += 1
        else:
            _PLANNING["depth"] -= 1
            if _PLANNING["depth"] == 0:
                for owner, name, raw in _PLANNING["saved"]:
                    setattr(owner, name, raw)
                _PLANNING["saved"] = []


# ---------------------------------------------------------------------------
# the mode
# ---------------------------------------------------------------------------


#: the innermost port functions a breakdown key keeps (the reference keeps
#: the first 8 parts of an op's name)
_KEY_DEPTH = 8


def _stack_key() -> str:
    """The port's functions on the Python stack, outermost first."""
    names = []
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("repro_torch.") and mod != __name__:
            names.append(f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names[:_KEY_DEPTH])) or "<outside the port>"


def _add(d: Optional[dict], key: str, v: float) -> None:
    if d is not None:
        d[key] = d.get(key, 0.0) + v


@dataclasses.dataclass
class Cost:
    """What ``OpCost`` counted (per rank); the fields of the reference's
    ``HloCost``."""
    flops: float = 0.0
    collective_bytes: float = 0.0
    traffic_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    traffic_by_meta: Optional[Dict[str, float]] = None
    flops_by_meta: Optional[Dict[str, float]] = None
    collective_by_meta: Optional[Dict[str, float]] = None


class OpCost(TorchDispatchMode):
    """Counts the per-rank cost of the ops run inside it into ``cost``."""

    def __init__(self, breakdown: bool = False):
        super().__init__()
        self.cost = Cost()
        if breakdown:
            self.cost.traffic_by_meta, self.cost.flops_by_meta, \
                self.cost.collective_by_meta = {}, {}, {}
        self.breakdown = breakdown
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flops = flop_registry

    def __enter__(self):
        _isolate_planning(True)
        try:
            return super().__enter__()
        except BaseException:
            _isolate_planning(False)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _isolate_planning(False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # count the local ops it becomes
        out = func(*args, **kwargs)
        self.count(func, args, kwargs, out)
        return out

    def count(self, func, args, kwargs, out) -> None:
        c = self.cost
        key = _stack_key() if self.breakdown else ""
        packet = func._overloadpacket
        if packet in self._flops:
            f = float(self._flops[packet](*args, **kwargs, out_val=out))
            c.flops += f
            _add(c.flops_by_meta, key, f)
        kind = collective_kind(func)
        if kind is not None:
            # result-shape bytes: the op's output tensors (the in-place
            # c10d ops return the tensors they wrote; a send returns none,
            # so its operand counts)
            b = _nbytes(out) or _nbytes(args[0])
            c.collective_by_kind[kind] += b
            c.collective_counts[kind] += 1
            c.collective_bytes += b
            _add(c.collective_by_meta, key, b)
        if _moves_data(func):
            b = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            c.traffic_bytes += b
            _add(c.traffic_by_meta, key, b)
