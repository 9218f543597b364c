"""The port's sharding layer against the reference's, in one process and
by shape only (no full-size tensor is allocated).

* ``repro_torch.sharding.context`` (a copy) behaves as
  ``repro.sharding.context``.
* ``ShardingPolicy.resolve`` and ``spec`` give the reference's decisions
  over a grid of dims x logical axes x meshes.
* For all 10 published configs on both production meshes, with and
  without FSDP, in the train and the serving layout, every parameter
  leaf's spec is the reference's ``param_shardings`` (shapes from
  ``repro.launch.specs.params_specs``) without the stacked layer dim the
  reference's scanned groups carry; the port's leaves come from the meta
  device.  The cache and optimizer specs likewise for a dense, a MoE and
  an SSM config.
* ``launch.mesh.make_mesh`` / ``make_production_mesh`` refuse a world
  smaller than the mesh.

Both policies run on a shape-only stand-in mesh (the reference's own
tests use one, tests/test_sharding.py); the reference's ``named`` is
replaced by its ``spec`` so that no ``NamedSharding`` (which needs real
devices) is built.
"""

import itertools
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.sharding import context as jctx  # noqa: E402
from repro.sharding import policy as jpolicy  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.sharding import context as tctx  # noqa: E402
from repro_torch.sharding import policy as tpolicy  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402


class FakeMesh:
    """Shape-only stand-in (resolve/spec never touch devices)."""

    def __init__(self, shape_dict):
        self._shape = dict(shape_dict)

    @property
    def shape(self):
        return self._shape

    @property
    def axis_names(self):
        return tuple(self._shape)


POD = {"data": 16, "model": 16}
MULTIPOD = {"pod": 2, "data": 16, "model": 16}
MESHES = {"pod": POD, "multipod": MULTIPOD,
          "1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2}}


def policies(mesh, fsdp=True, serving=False, seq_parallel=False):
    """(reference policy, port policy) on the same stand-in mesh."""
    ref = jpolicy.ShardingPolicy(mesh=FakeMesh(mesh), fsdp=fsdp,
                                 seq_parallel=seq_parallel, serving=serving)
    ref.named = ref.spec            # specs, not NamedShardings
    ref.replicated = lambda: jax.sharding.PartitionSpec()
    port = tpolicy.ShardingPolicy(mesh=FakeMesh(mesh), fsdp=fsdp,
                                  seq_parallel=seq_parallel,
                                  serving=serving)
    return ref, port


def as_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def ref_leaves(tree, prefix=()):
    """{path tuple: leaf} of a reference pytree (dict keys only)."""
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def unstacked(ref_specs: dict, cfg, root: str) -> dict:
    """The reference's specs under ``root`` (``stack`` of a parameter,
    moment or cache tree) keyed by the port's per-layer path: a scanned
    group's spec loses its leading stacked dim."""
    out = {}
    for gname, idx, stacked in convert.layer_groups(cfg):
        for path, spec in ref_specs.items():
            if path[:2] != (root, gname):
                continue
            for i in idx:
                out[("layers", i) + path[2:]] = (
                    as_tuple(spec)[1:] if stacked else as_tuple(spec))
    return out


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------


class Recorder:
    def __init__(self, tag):
        self.tag = tag

    def constrain(self, x, axes):
        return (self.tag, x, tuple(axes))


def test_context_copy_behaves_as_the_reference():
    for ctx in (jctx, tctx):
        assert ctx.current() is None
        assert ctx.constrain("x", ("batch", None)) == "x"
        a, b = Recorder("a"), Recorder("b")
        with ctx.use_policy(a) as got:
            assert got is a and ctx.current() is a
            assert ctx.constrain("x", ["batch"]) == ("a", "x", ("batch",))
            with ctx.use_policy(b):
                assert ctx.current() is b
                seen = []
                t = threading.Thread(target=lambda: seen.append(
                    ctx.current()))
                t.start()
                t.join()
                assert seen == [None]        # thread-local
            assert ctx.current() is a
        assert ctx.current() is None
        with pytest.raises(KeyError):
            with ctx.use_policy(a):
                raise KeyError("inner")
        assert ctx.current() is None


# ---------------------------------------------------------------------------
# resolve / spec
# ---------------------------------------------------------------------------

LOGICAL = (None, "batch", "fsdp", "heads", "kv_heads", "vocab", "experts",
           "mlp", "model", "seq", "expert_ff", "kv_seq")
DIMS = (1, 2, 3, 4, 8, 24, 32, 48, 64, 384, 512, 2048)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("flags", list(itertools.product((True, False),
                                                         repeat=3)))
def test_resolve_and_spec_match_the_reference(mesh, flags):
    fsdp, serving, seq = flags
    ref, port = policies(MESHES[mesh], fsdp, serving, seq)
    for d, a in itertools.product(DIMS, LOGICAL):
        assert port.resolve(d, a) == ref.resolve(d, a), (d, a)
    for shape in itertools.product((8, 24, 384), repeat=3):
        for axes in itertools.product(LOGICAL[:9], repeat=3):
            assert port.spec(shape, axes) == as_tuple(
                ref.spec(shape, axes)), (shape, axes)
    for S, H in itertools.product((1, 16, 24, 4096), (8, 24, 64)):
        assert port.attn_q_axes(S, H) == ref.attn_q_axes(S, H)
        assert port.use_seq_attention(S, H) == ref.use_seq_attention(S, H)
    for which in ("gate_up", "down"):
        assert port.moe_axes(which) == ref.moe_axes(which)


# ---------------------------------------------------------------------------
# parameter, cache and optimizer specs of the published configs
# ---------------------------------------------------------------------------

_CACHE = {}


def ref_params(arch):
    key = ("ref", arch)
    if key not in _CACHE:
        _CACHE[key] = jspecs.params_specs(jconfigs.get_config(arch))
    return _CACHE[key]


def port_params(arch):
    key = ("port", arch)
    if key not in _CACHE:
        _CACHE[key] = tm.init_params(tconfigs.get_config(arch),
                                     torch.Generator(), "meta")
    return _CACHE[key]


def expected_param_specs(arch, ref):
    cfg = tconfigs.get_config(arch)
    specs = ref_leaves(ref.param_shardings(ref_params(arch)))
    want = unstacked(specs, cfg, "stack")
    for path, spec in specs.items():
        if path[0] == "stack":
            continue
        if path[:2] == ("encoder", "blocks"):
            for i in range(cfg.num_encoder_layers):
                want[path[:2] + (i,) + path[2:]] = as_tuple(spec)[1:]
        else:
            want[path] = as_tuple(spec)
    return want


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("serving", [False, True])
def test_param_specs_match_the_reference(arch, mesh, fsdp, serving):
    ref, port = policies(MESHES[mesh], fsdp, serving)
    params = port_params(arch)
    got = {p: s for p, s in _spec_leaves(port.param_shardings(params))}
    want = expected_param_specs(arch, ref)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == want[path], path
        assert len(spec) == tree_get_ndim(params, path)


def _spec_leaves(tree, prefix=()):
    """(path, spec) pairs of a tree of specs (tuples are leaves)."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _spec_leaves(v, prefix + (k,))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree)
                for pl in _spec_leaves(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_get_ndim(tree, path):
    for k in path:
        tree = tree[k]
    return tree.ndim


@pytest.mark.parametrize("arch", ["yi-6b", "kimi-k2-1t-a32b",
                                  "mamba2-1.3b"])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_cache_and_optimizer_specs_match_the_reference(arch, mesh):
    ref, port = policies(MESHES[mesh])
    cfg = tconfigs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    # caches: batch 32, 4096 positions
    jcache = jspecs.cache_specs(jcfg, 32, 4096)
    specs = ref_leaves(ref.cache_shardings(jcache))
    want = unstacked({("stack",) + p: s for p, s in specs.items()
                      if p[0] not in ("pos", "slot_pos")}, cfg, "stack")
    for key in ("pos", "slot_pos"):
        want[(key,)] = as_tuple(specs[(key,)])
    cache = tt.init_cache(cfg, 32, 4096, device="meta")
    got = dict(_spec_leaves(port.cache_shardings(cache)))
    assert got == want
    # optimizer states: AdamW moments per layer, Adafactor statistics in
    # the reference's stacked groups
    params = port_params(arch)
    jparams = ref_params(arch)
    for name in ("adamw", "adafactor"):
        jstate = jax.eval_shape(jopt.make_optimizer(name, 1e-3).init,
                                jparams)
        rspecs = ref_leaves(ref.opt_shardings(jstate))
        state = topt.make_optimizer(name, 1e-3, cfg).init(params)
        got = dict(_spec_leaves(port.opt_shardings(state)))
        if name == "adamw":
            want = {("step",): as_tuple(rspecs[("step",)])}
            for m in ("mu", "nu"):
                sub = {p[1:]: s for p, s in rspecs.items() if p[0] == m}
                want.update({(m,) + p: s for p, s in
                             unstacked(sub, cfg, "stack").items()})
                want.update({(m,) + p: as_tuple(s) for p, s in sub.items()
                             if p[0] != "stack"})
        else:
            want = {("step",): as_tuple(rspecs[("step",)])}
            for p, s in rspecs.items():
                if p[0] == "stats":
                    want[("stats", "/".join(p[1:-1]), p[-1])] = as_tuple(s)
        assert got == want, name


def test_make_mesh_refuses_a_world_too_small():
    with pytest.raises(RuntimeError, match="needs 8 ranks, have 1"):
        tmesh.make_mesh((2, 4), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="needs 256 ranks, have 1"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks, have 1"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        tmesh.make_mesh((2, 2), ("data",), "cpu")
