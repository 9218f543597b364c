"""PyTorch port: the engine's CUDA-graph executables, on the CPU.

  * capture safety — every function the continuous engine captures (both
    decode windows, both stall admissions, the copy-on-write page copy,
    the fused ragged prefill), on the dense, MoE, sliding-window and
    recurrent smoke models, and the MoE layer alone, runs at the smoke
    size on the ``meta`` device, which stands in for the card, under a
    ``TorchFunctionMode`` and a ``TorchDispatchMode`` that fail on any
    operation a capture forbids: a read of a device value on the host
    (``aten._local_scalar_dense`` and the like), a data-dependent shape
    (``nonzero``, boolean-mask indexing) or a copy between host and
    device.  The attention kernels and the paged path's fused pointwise
    kernels are stubbed (the RoPE stubs check that the cache's cos/sin
    table is bound): on the card the CUDA kernels run in their place, and
    their plain versions never do.  The
    checker itself is held to the two host reads the port had before its
    graphs (a ``torch.tensor`` of a Python int on the device, an ``int()``
    of a device index);
  * tensor indices — ``write_slot``, ``write_paged``, ``copy_paged_block``,
    ``prefill_into_slot`` and ``prefill_into_paged`` given 1-element
    tensor indices equal their int forms bit for bit, and the JAX
    functions as the other model tests hold them;
  * ``GraphExecutable`` on the CPU — nothing is captured, ``call_aot``
    equals ``__call__``, ``disable_graphs()`` nests; its capture and
    replay bookkeeping (static inputs, bound arguments, the kernels'
    launch counts) through a stand-in graph that records the function;
  * the engine — ``aot_warmup`` is reported and changes nothing on the
    CPU, every device step goes through the executables, and the warm-up
    captures exactly the keys the reference's ``_aot_warm`` compiles.

The card's side (graphed against eager, bit for bit) is in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import torch_engine_setup as es  # noqa: E402

from repro.models import model as jm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import generate as jgenerate  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import paged_decode_attention as tpfd  # noqa: E402
from repro_torch.kernels import ragged_chunked_prefill as trcp  # noqa: E402
from repro_torch.kernels import rms_norm as trn  # noqa: E402
from repro_torch.kernels import rope_kv as trope  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving import generate as tgen  # noqa: E402

DEVICE = "meta"          # the card's stand-in: shapes only, no values

# ---------------------------------------------------------------------------
# (a) capture safety
# ---------------------------------------------------------------------------


class HostTraffic(AssertionError):
    """An operation a CUDA-graph capture forbids."""


# aten operators that read a device value on the host or whose output
# shape depends on device data (both synchronise with the host)
_SYNC_OPS = {"_local_scalar_dense", "is_nonzero", "equal", "nonzero",
             "masked_select", "_unique2", "unique_dim", "unique_consecutive",
             "item"}
_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
_COPY_OPS = {"_to_copy", "copy_", "lift_fresh", "lift_fresh_copy"}
_FACTORIES = {"tensor", "as_tensor", "asarray"}
_SCALAR_READS = {"item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"}


def _tensors(*trees):
    for x in trees:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(*x)
        elif isinstance(x, dict):
            yield from _tensors(*x.values())


def _on(ts, kind):
    return any(t.device.type == kind for t in ts)


class _FunctionCheck(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        ins = list(_tensors(args, kwargs))
        if name in _SCALAR_READS and _on(ins, DEVICE):
            raise HostTraffic(f"{name}() reads a device value on the host")
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if _on(outs, DEVICE) and name in _FACTORIES and not _on(ins, DEVICE):
            raise HostTraffic(f"torch.{name}() copies host data to the "
                              "device")
        if _on(outs, DEVICE) and _on(ins, "cpu"):
            raise HostTraffic(f"{name}: a host tensor copied to the device")
        if _on(outs, "cpu") and _on(ins, DEVICE):
            raise HostTraffic(f"{name}: a device tensor copied to the host")
        return out


class _DispatchCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        ins = list(_tensors(args, kwargs))
        if name in _SYNC_OPS and _on(ins, DEVICE):
            raise HostTraffic(f"aten.{name} on the device synchronises")
        if name in _INDEX_OPS and any(
                t.dtype in (torch.bool, torch.uint8)
                for t in _tensors(args[1:]) if t.device.type == DEVICE):
            raise HostTraffic(f"aten.{name} with a boolean mask: a "
                              "data-dependent shape")
        if name in _COPY_OPS:
            src = args[-1].device if name == "copy_" else args[0].device
            dst = (args[0].device if name == "copy_"
                   else torch.device(kwargs.get("device") or src))
            if {src.type, dst.type} == {"cpu", DEVICE} or (
                    name.startswith("lift_fresh") and src.type == DEVICE):
                raise HostTraffic(f"aten.{name}: a copy between host and "
                                  "device")
        return func(*args, **kwargs)


def capture_safe(fn, *args, **kwargs):
    """Run ``fn`` under both checks; raises ``HostTraffic``."""
    with _FunctionCheck(), _DispatchCheck():
        return fn(*args, **kwargs)


def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_meta(v) for v in tree]
    return tree.to(DEVICE)


@pytest.fixture(scope="module")
def meta_model():
    cfg = configs.get_smoke_config("starcoder2-3b")
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, _to_meta(params)


@pytest.fixture
def stub_kernels(monkeypatch):
    """The CUDA kernels' place on the card: outputs of the right shape,
    no plain version (which the card never runs)."""
    monkeypatch.setattr(tpfd, "paged_flash_decode_attention",
                        lambda q, *a: torch.empty_like(q))
    monkeypatch.setattr(trcp, "ragged_chunked_prefill",
                        lambda q, *a: torch.empty_like(q))
    monkeypatch.setattr(trn, "rms_norm",
                        lambda x, *a: torch.empty_like(x))
    monkeypatch.setattr(trn, "add_rms_norm",
                        lambda x, *a: (torch.empty_like(x),
                                       torch.empty_like(x)))

    def rope_decode(q, k, v, pos, tables, k_pages, v_pages, *, theta,
                    table):
        assert table is not None and table.device == q.device
        return torch.empty_like(q[:, 0])

    def rope_packed(q, k, v, positions, rows=None, *, theta, table):
        assert table is not None and table.device == q.device
        R = q.shape[0] if rows is None else rows.shape[0]
        return (q.new_empty((R,) + q.shape[1:]),
                k.new_empty((R,) + k.shape[1:]),
                None if v is None else v.new_empty((R,) + v.shape[1:]))
    monkeypatch.setattr(trope, "rope_kv_decode", rope_decode)
    monkeypatch.setattr(trope, "rope_kv_packed", rope_packed)


C, S, BS, NB, W = 3, 8, 4, 4, 16


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32, device=DEVICE)


def _graphed_calls(cfg, params):
    """name -> (fn, args, kwargs) of every function the engine captures,
    with the engine's argument forms: 1-element index tensors, int32
    tables and metadata."""
    paged = (tt.init_paged_cache(cfg, C, C * NB + 1, BS, device=DEVICE)
             if tt.paged_supported(cfg)[0] else None)
    ring = tt.init_slot_cache(cfg, C, W, device=DEVICE)
    TTp, Cp, Tp = 8, 2, 4
    return {
        "window paged": (tm.decode_steps_paged,
                         (params, cfg, paged, _i32(C, 1), _i32(C, NB)),
                         {"num_steps": 2, "use_kernels": True}),
        "window ring": (tm.decode_steps, (params, cfg, ring, _i32(C, 1)),
                        {"num_steps": 2}),
        "admit paged": (tm.prefill_into_paged,
                        (params, cfg, paged, _i32(1, S), _i32(1), _i32(NB)),
                        {"max_len": W}),
        "admit ring": (tm.prefill_into_slot,
                       (params, cfg, ring, _i32(1, S), _i32(1)),
                       {"max_len": W}),
        "cow": (tt.copy_paged_block, (paged, _i32(1), _i32(1)), {}),
        "ragged": (tm.prefill_chunks,
                   (params, cfg, paged, _i32(1, TTp), _i32(TTp),
                    _i32(Cp, 4), _i32(Cp, NB)),
                   {"chunk_pad": Tp, "use_kernels": True}),
    }


@pytest.mark.parametrize("name", ["window paged", "window ring",
                                  "admit paged", "admit ring", "cow",
                                  "ragged"])
def test_graphed_functions_are_capture_safe(meta_model, stub_kernels,
                                            name):
    fn, args, kwargs = _graphed_calls(*meta_model)[name]
    capture_safe(fn, *args, **kwargs)


@pytest.fixture(scope="module")
def family_models():
    """The MoE, sliding-window and recurrent smoke models on the ``meta``
    device; the windows cut to 4 so the S = 8 admission prefill runs the
    windowed attention and wraps the ring, and mamba2's SSD chunk to 3,
    so the admission's scan runs three chunks, the last padded."""
    out = {}
    for name in ("kimi-k2-1t-a32b", "mixtral-8x22b", "h2o-danube-3-4b",
                 "mamba2-1.3b", "recurrentgemma-9b"):
        cfg = configs.get_smoke_config(name)
        if cfg.window:
            cfg = dataclasses.replace(cfg, window=4)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, local_window=4)
        if cfg.family == "ssm":
            cfg = dataclasses.replace(cfg, ssm_chunk=3)
        params = tm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out[name] = (cfg, _to_meta(params))
    return out


@pytest.mark.parametrize("name,call", [
    ("kimi-k2-1t-a32b", "window paged"), ("kimi-k2-1t-a32b", "window ring"),
    ("kimi-k2-1t-a32b", "admit paged"), ("kimi-k2-1t-a32b", "admit ring"),
    ("kimi-k2-1t-a32b", "ragged"), ("mixtral-8x22b", "window ring"),
    ("mixtral-8x22b", "admit ring"), ("h2o-danube-3-4b", "window ring"),
    ("h2o-danube-3-4b", "admit ring")])
def test_moe_and_window_steps_are_capture_safe(family_models, stub_kernels,
                                               name, call):
    """MoE routing (router, stable sorts, searchsorted, the capacity
    plan, the spare-row dispatch, the fixed-order combine) and the
    windowed prefill and ring decode read nothing back on the host, so
    the engine's graphs capture them."""
    fn, args, kwargs = _graphed_calls(*family_models[name])[call]
    capture_safe(fn, *args, **kwargs)


@pytest.mark.parametrize("call", ["window ring", "admit ring"])
@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_recurrent_steps_are_capture_safe(family_models, name, call):
    """The SSD scan (its chunk loop and padding), the RG-LRU doubling
    scan, the conv tails, the in-place state updates and the local
    attention's ring read nothing back on the host, so the engine's
    graphs capture the recurrent families' decode windows and stall
    admissions."""
    fn, args, kwargs = _graphed_calls(*family_models[name])[call]
    capture_safe(fn, *args, **kwargs)


@pytest.mark.parametrize("S", [1, 8, 40])
def test_moe_layer_is_capture_safe(family_models, S):
    cfg, params = family_models["kimi-k2-1t-a32b"]
    moe = [p["moe"] for p in params["layers"] if "moe" in p][0]
    x = torch.zeros((2, S, cfg.d_model), dtype=torch.bfloat16, device=DEVICE)
    out, aux = capture_safe(tmoe.apply_moe_local, moe, x, cfg)
    assert out.shape == x.shape and out.device.type == DEVICE
    assert all(a.device.type == DEVICE for a in aux.values())


def _old_prefill_pos(S):
    # model.prefill's ``pos`` before the graphs: a Python int copied to
    # the device
    return torch.tensor(S, dtype=torch.int32, device=DEVICE)


def _old_copy_block(pages, src, dst):
    # paged.copy_block before the graphs: device indices read on the host
    pages[int(dst)] = pages[int(src)]


@pytest.mark.parametrize("case", ["prefill pos", "copy_block"])
def test_checker_catches_the_ports_old_host_reads(case):
    if case == "prefill pos":
        call = (_old_prefill_pos, 8)
    else:
        pages = torch.zeros((5, 4, 2, 8), device=DEVICE)
        call = (_old_copy_block, pages, _i32(1), _i32(1))
    with pytest.raises(HostTraffic):
        capture_safe(*call)


def test_checker_catches_boolean_masks_and_readbacks():
    x = torch.zeros((6, 2), device=DEVICE)
    keep = torch.zeros((6,), dtype=torch.bool, device=DEVICE)
    for bad in (lambda: x[keep], lambda: bool(keep.any()),
                lambda: x.cpu()):
        with pytest.raises(HostTraffic):
            capture_safe(bad)
    capture_safe(lambda: x[torch.zeros((3,), dtype=torch.long,
                                       device=DEVICE)] + 1.0)


# ---------------------------------------------------------------------------
# (b) tensor indices: bit for bit with the int forms and with JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    cfg = es.cfg32()
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, jp, tp


def _idx(i):
    return torch.tensor([i], dtype=torch.int32)


def _pools(cfg, N, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, N, bs, cfg.num_kv_heads, cfg.head_dim)
    return [rng.standard_normal(shape, np.float32) for _ in range(2)]


def _tcache(k, v, **rest):
    c = {"layers": [{"k": torch.from_numpy(k[i]).to(torch.bfloat16),
                     "v": torch.from_numpy(v[i]).to(torch.bfloat16)}
                    for i in range(k.shape[0])]}
    c.update({n: torch.from_numpy(np.array(a)) for n, a in rest.items()})
    return c


def _jcache(k, v, **rest):
    c = {"scan0": {"k": jnp.asarray(k).astype(jnp.bfloat16),
                   "v": jnp.asarray(v).astype(jnp.bfloat16)}}
    c.update({n: jnp.asarray(a) for n, a in rest.items()})
    return c


def _same_bits(a, b):
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


def _caches_equal(a, b):
    for la, lb in zip(a["layers"], b["layers"]):
        _same_bits(la["k"], lb["k"])
        _same_bits(la["v"], lb["v"])
    for n in a:
        if n != "layers":
            assert torch.equal(a[n], b[n]), n


def _matches_jax(tc, jc):
    for i, lc in enumerate(tc["layers"]):
        for kv in ("k", "v"):
            np.testing.assert_array_equal(
                lc[kv].view(torch.int16).numpy(),
                np.asarray(jc["scan0"][kv][i]).view(np.int16))
    for n in tc:
        if n != "layers":
            np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


def test_write_slot_tensor_index(models):
    cfg = models[0]
    k, v = _pools(cfg, 3, W, seed=11)
    ok, ov = _pools(cfg, 1, W, seed=12)
    rest = dict(pos=np.asarray([4, 9, 2], np.int32),
                slot_pos=np.arange(3 * W, dtype=np.int32).reshape(3, W))
    one = dict(pos=np.int32(7), slot_pos=np.arange(W, dtype=np.int32) * 2)
    by_int, by_tensor = _tcache(k, v, **rest), _tcache(k, v, **rest)
    tt.write_slot(by_int, _tcache(ok, ov, **one), 2)
    tt.write_slot(by_tensor, _tcache(ok, ov, **one), _idx(2))
    _caches_equal(by_tensor, by_int)
    want = jt.write_slot(_jcache(k, v, **rest),
                         {"scan0": {"k": jnp.asarray(ok),
                                    "v": jnp.asarray(ov)},
                          "pos": jnp.asarray(one["pos"]),
                          "slot_pos": jnp.asarray(one["slot_pos"])},
                         jnp.int32(2))
    _matches_jax(by_tensor, want)


def test_write_paged_tensor_index(models):
    cfg = models[0]
    k, v = _pools(cfg, 9, BS, seed=13)
    ok, ov = _pools(cfg, 1, W, seed=14)
    rest = dict(pos=np.asarray([3, 5, 0], np.int32))
    row = np.asarray([6, 2, 8, 0], np.int32)
    seq_len = 11
    one = {"layers": [{"k": torch.from_numpy(ok[i]),
                       "v": torch.from_numpy(ov[i])}
                      for i in range(cfg.num_layers)]}
    by_int, by_tensor = _tcache(k, v, **rest), _tcache(k, v, **rest)
    tt.write_paged(by_int, one, 1, torch.from_numpy(row), seq_len)
    tt.write_paged(by_tensor, one, _idx(1), torch.from_numpy(row), seq_len)
    _caches_equal(by_tensor, by_int)
    want = jt.write_paged(_jcache(k, v, **rest),
                          {"scan0": {"k": jnp.asarray(ok),
                                     "v": jnp.asarray(ov)}},
                          jnp.int32(1), jnp.asarray(row), seq_len)
    _matches_jax(by_tensor, want)


def test_copy_paged_block_tensor_index(models):
    cfg = models[0]
    k, v = _pools(cfg, 7, BS, seed=15)
    rest = dict(pos=np.asarray([3, 9], np.int32))
    by_int, by_tensor = _tcache(k, v, **rest), _tcache(k, v, **rest)
    tt.copy_paged_block(by_int, 2, 5)
    tt.copy_paged_block(by_tensor, _idx(2), _idx(5))
    _caches_equal(by_tensor, by_int)
    want = jt.copy_paged_block(_jcache(k, v, **rest), jnp.int32(2),
                               jnp.int32(5))
    _matches_jax(by_tensor, want)


def test_prefill_into_slot_and_paged_tensor_index(models):
    """Both admissions with a tensor slot equal the int form bit for bit
    (logits and cache) and the JAX admission by the rule of the other
    stall tests (logits within 2e-3, the cache by ``assert_kv``)."""
    cfg, jp, tp = models
    prompt = np.random.default_rng(16).integers(
        2, cfg.vocab_size, (1, S)).astype(np.int32)
    row = np.asarray([5, 1, 7, 2], np.int32)
    runs = {}
    for form, slot in (("int", 1), ("tensor", _idx(1))):
        ring = tt.init_slot_cache(cfg, 2, W, device="cpu")
        paged = tt.init_paged_cache(cfg, 2, 9, BS, device="cpu")
        runs[form] = (
            ring, tm.prefill_into_slot(tp, cfg, ring, torch.from_numpy(prompt),
                                       slot, W),
            paged, tm.prefill_into_paged(tp, cfg, paged,
                                         torch.from_numpy(prompt), slot,
                                         torch.from_numpy(row), W))
    (ri, li, pi, lpi), (rt, lt, pt, lpt) = runs["int"], runs["tensor"]
    _caches_equal(rt, ri)
    _caches_equal(pt, pi)
    assert torch.equal(lt, li) and torch.equal(lpt, lpi)
    batch = {"tokens": jnp.asarray(prompt)}
    jring, jl = jm.prefill_into_slot(
        jp, cfg, jt.init_slot_cache(cfg, 2, W), batch, jnp.int32(1), W)
    jpaged, jlp = jm.prefill_into_paged(
        jp, cfg, jt.init_paged_cache(cfg, 2, 9, BS), batch, jnp.int32(1),
        jnp.asarray(row), W)
    for got, want in ((lt, jl), (lpt, jlp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-3, rtol=2e-3)
    es.assert_kv(rt["layers"], jring, cfg)
    es.assert_kv(pt["layers"], jpaged, cfg)
    np.testing.assert_array_equal(rt["pos"].numpy(), np.asarray(jring["pos"]))
    np.testing.assert_array_equal(rt["slot_pos"].numpy(),
                                  np.asarray(jring["slot_pos"]))
    np.testing.assert_array_equal(pt["pos"].numpy(),
                                  np.asarray(jpaged["pos"]))


# ---------------------------------------------------------------------------
# (c) GraphExecutable on the CPU
# ---------------------------------------------------------------------------


def test_executable_on_the_cpu_never_captures(models):
    cfg, _, tp = models
    prompt = np.random.default_rng(17).integers(
        2, cfg.vocab_size, (1, S)).astype(np.int32)
    caches = [tt.init_slot_cache(cfg, 2, W, device="cpu") for _ in range(2)]
    ex = tgen.GraphExecutable(tm.prefill_into_slot, "admit", "cpu")
    assert not ex.captures()
    ex.warm(("admit",), (tp, cfg, caches[0], prompt, np.zeros(1, np.int32)),
            {"max_len": W})
    assert ex.aot == {}
    got = ex.call_aot(("admit",), tp, cfg, caches[0], prompt,
                      np.array([1], np.int32), max_len=W)
    want = ex(tp, cfg, caches[1], prompt, np.array([1], np.int32),
              max_len=W)
    assert ex.aot == {} and ex.replays == 0
    assert torch.equal(got, want)
    _caches_equal(caches[0], caches[1])


def test_disable_graphs_nests():
    assert not tgen.graphs_disabled()
    with tgen.disable_graphs():
        assert tgen.graphs_disabled()
        with tgen.disable_graphs():
            assert tgen.graphs_disabled()
        assert tgen.graphs_disabled()
    assert not tgen.graphs_disabled()


class _Recording:
    """A stand-in for ``torch.cuda.CUDAGraph``: the function called under
    ``_record`` appends its body, and ``replay`` runs the bodies again on
    the buffers they were given."""

    current = None

    def __init__(self):
        self.bodies = []

    def replay(self):
        for body in self.bodies:
            body()


class _record:
    def __init__(self, graph, pool=None):
        self.graph = graph
        self.capture_stream = None

    def __enter__(self):
        _Recording.current = self.graph

    def __exit__(self, *exc):
        _Recording.current = None


def _recordable_add(state, x, *, scale):
    """state["acc"] += scale * x, counted as one paged-decode launch where
    it is launched (on the host), as a kernel wrapper counts."""
    def body():
        state["acc"].add_(x * scale)
    tpfd.launches += 1
    if _Recording.current is not None:
        _Recording.current.bodies.append(body)
    else:
        body()
    return state["acc"]


def test_capture_and_replay_bookkeeping(monkeypatch):
    """Through a stand-in graph: the first call of a key runs eagerly and
    captures it, later calls copy their inputs into the static buffers
    and replay; the launch count moves where the function is called (the
    eager call and the capture), never at a replay; a replay against another
    bound object, shape or static kwarg raises."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recording)
    monkeypatch.setattr(torch.cuda, "graph", _record)
    monkeypatch.setattr(tgen.GraphExecutable, "captures",
                        lambda self: not tgen.graphs_disabled())
    state = {"acc": torch.zeros(3)}
    ex = tgen.GraphExecutable(_recordable_add, "add", "cpu")
    launches = tpfd.launches
    out = ex.call_aot("k", state, np.array([1.0, 2.0, 3.0], np.float32),
                      scale=2.0)
    assert torch.equal(out, torch.tensor([2.0, 4.0, 6.0]))
    assert list(ex.aot) == ["k"] and ex.replays == 0
    assert tpfd.launches == launches + 2          # eager call, capture
    for step in range(3):
        x = np.full(3, float(step), np.float32)
        out = ex.call_aot("k", state, x, scale=2.0)
    assert ex.replays == 3
    assert tpfd.launches == launches + 2          # replays run no Python
    assert torch.equal(out, torch.tensor([8.0, 10.0, 12.0]))
    assert out is ex.aot["k"].out                 # the static output
    ex.warm("k", (state, np.zeros(3, np.float32)), {"scale": 2.0})
    assert ex.replays == 3                        # idempotent per key
    for bad in (lambda: ex.call_aot("k", {"acc": torch.zeros(3)},
                                    np.zeros(3, np.float32), scale=2.0),
                lambda: ex.call_aot("k", state, np.zeros(4, np.float32),
                                    scale=2.0),
                lambda: ex.call_aot("k", state, np.zeros(3, np.float32),
                                    scale=3.0)):
        with pytest.raises(ValueError):
            bad()
    with tgen.disable_graphs():
        ex.call_aot("k", state, np.ones(3, np.float32), scale=1.0)
    assert ex.replays == 3
    assert torch.equal(state["acc"], torch.tensor([9.0, 11.0, 13.0]))
    ex.reset()
    assert ex.aot == {} and ex.replays == 0


# ---------------------------------------------------------------------------
# (d) the engine
# ---------------------------------------------------------------------------

ROWS = {
    "contiguous-stall": dict(mode="continuous", prefill="stall",
                             decode_steps=2),
    "paged-stall-prefix": dict(mode="continuous", kv="paged",
                               prefill="stall", prefix_cache=True,
                               decode_steps=2),
    "paged-chunked-prefix": dict(mode="continuous", kv="paged",
                                 prefill="chunked", chunk_size=es.CHUNK,
                                 token_budget=es.BUDGET, prefix_cache=True,
                                 decode_steps=2),
}
SCHEDULING = ("completion_order", "budget_trace", "prefill_dispatches",
              "prefill_dispatch_trace", "decode_dispatches",
              "decode_dispatch_trace", "exec_cache_hits",
              "exec_cache_misses", "rejected_for_memory", "kv_util_peak",
              "kv_util_mean", "cow_copies", "cached_tokens_reused",
              "prefix_hit_rate")


@pytest.fixture(scope="module")
def setup():
    return es.make_setup()


def _shared_prefix_texts(texts):
    shared = " ".join(texts[0].split()[:6])
    return [f"{shared} {t}" for t in texts]


@pytest.mark.parametrize("row", sorted(ROWS))
def test_aot_warmup_is_reported_and_changes_nothing(setup, row):
    """``res["pipeline"]["aot_warmup"]`` is True by default and False
    when asked; tokens and every scheduling field are the same either
    way (the reference's tests/test_async_pipeline.py:483).  Every device
    step went through the engine's executables, and on the CPU none
    captured a graph."""
    texts = _shared_prefix_texts(setup["texts"])
    runs = {}
    for warm in (True, False):
        kw = dict(ROWS[row])
        if not warm:
            kw["aot_warmup"] = False
        eng = es.port_engine(setup, "rt-lm", **kw)
        calls = {}
        for name, ex in eng._executables().items():
            def counted(*a, _fn=ex.fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            ex.fn = counted
        res = eng.serve(es.requests(tengine, texts))
        runs[warm] = res
        assert res["pipeline"]["aot_warmup"] is warm
        assert all(ex.aot == {} for ex in eng._executables().values())
        assert calls.get("window", 0) == res["decode_dispatches"] > 0
        assert calls.get("cow", 0) == res["cow_copies"]
        admits = calls.get("admit", 0) + calls.get("ragged", 0)
        assert admits == res["prefill_dispatches"] > 0
    for field in SCHEDULING:
        assert runs[True][field] == runs[False][field], field
    assert es.tokens(runs[True]) == es.tokens(runs[False])


WARM_ROWS = [
    dict(kv="contiguous", prefill="stall"),
    dict(kv="paged", prefill="stall"),
    dict(kv="paged", prefill="stall", prefix_cache=True),
    dict(kv="paged", prefill="chunked"),
    dict(kv="paged", prefill="chunked", prefix_cache=True),
]


@pytest.mark.parametrize("kw", WARM_ROWS,
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_warmup_captures_the_references_keys(setup, monkeypatch, kw):
    """The keys the port's warm-up captures are the ones the reference's
    ``_aot_warm`` compiles, executable for executable (both warm-ups run
    with their ``warm`` recording keys instead of compiling)."""
    kw = dict(mode="continuous", decode_steps=4, chunk_size=es.CHUNK,
              token_budget=es.BUDGET, **kw)
    got, want = set(), set()
    monkeypatch.setattr(tgen.GraphExecutable, "captures", lambda self: True)
    monkeypatch.setattr(
        tgen.GraphExecutable, "warm",
        lambda self, key, args, static_kwargs=None: got.add(
            (self.name, key)))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a, **k: 0)
    monkeypatch.setattr(
        jgenerate.JitExecutable, "warm",
        lambda self, key, args, static_kwargs=None: want.add(
            (self.name.split(":")[1], key)))
    kvc = types.SimpleNamespace(max_blocks_per_seq=5)
    es.port_engine(setup, "fifo", **kw)._aot_warm(None, kvc)
    es.jax_engine(setup, "fifo", **kw)._aot_warm(None, kvc)
    names = {"paged_decode_steps": "window", "decode_steps": "window",
             "paged_prefill": "admit", "slot_prefill": "admit",
             "copy_block": "cow", "ragged": "ragged"}
    assert got == {(names[n], key) for n, key in want}
    assert got
