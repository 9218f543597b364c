"""PyTorch port: host-side modules held against the JAX package.

  * configs — every ``ARCH_IDS`` entry equal field for field;
  * import guard — ``src/repro_torch`` and ``chip_smoke.py`` import neither
    ``jax`` nor ``repro``, and importing the port's engine leaves ``jax``
    out of ``sys.modules``;
  * framework-free copies — RULEGEN features, priorities, every policy's
    ``admit``/``select``, ``ChunkScheduler``/``pack_plans``/
    ``build_packed_arrays``, the block allocator and
    ``window_target_tokens`` give identical outputs on identical inputs;
  * predictor — with the reference weights carried over, the forward pass
    matches within 1e-5 and one Adam step within a stated tolerance.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jcfgs  # noqa: E402
from repro.core import (datagen as jdatagen, personas as jpersonas,  # noqa: E402
                        predictor as jpred, priority as jprio,
                        rulegen as jrulegen, scheduler as jsched)
from repro.kvcache import allocator as jalloc  # noqa: E402
from repro.prefill import scheduler as jchunk  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.core import (datagen as tdatagen,  # noqa: E402
                              personas as tpersonas, predictor as tpred,
                              priority as tprio, rulegen as trulegen,
                              scheduler as tsched)
from repro_torch.kvcache import allocator as talloc  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.prefill import scheduler as tchunk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_configs_field_for_field(arch):
    assert tuple(tcfgs.ARCH_IDS) == tuple(jcfgs.ARCH_IDS)
    for get in ("get_config", "get_smoke_config"):
        a = dataclasses.asdict(getattr(jcfgs, get)(arch))
        b = dataclasses.asdict(getattr(tcfgs, get)(arch))
        assert a == b, (arch, get)


# ---------------------------------------------------------------------------
# import guard
# ---------------------------------------------------------------------------


def _foreign_imports(path: Path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((str(path), node.lineno, n))
    return bad


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [b for f in files for b in _foreign_imports(f)]
    assert bad == []


def test_engine_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.serving.engine, chip_smoke; "
            "sys.exit(int(any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro' for m in sys.modules)))")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# framework-free copies
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    a = jdatagen.generate_corpus(jdatagen.VARIANCE_MIXES["normal"], 48,
                                 seed=3)
    b = tdatagen.generate_corpus(tdatagen.VARIANCE_MIXES["normal"], 48,
                                 seed=3)
    return a, b


def test_datagen_and_rulegen_identical(corpus):
    a, b = corpus
    assert [t.text for t in a] == [t.text for t in b]
    assert [t.out_lens for t in a] == [t.out_lens for t in b]
    for ta, tb in zip(a, b):
        np.testing.assert_array_equal(jrulegen.features(ta.text),
                                      trulegen.features(tb.text))


def _sim_pair(n, seed):
    """The same queue of SimTasks built for both packages."""
    rng = np.random.default_rng(seed)
    us = rng.uniform(0.0, 300.0, n)
    rs = np.sort(rng.uniform(0.0, 5.0, n))
    lens = rng.integers(3, 40, n)
    out = []
    for prio in (jprio, tprio):
        out.append([prio.SimTask(
            task=i, u=float(us[i]), r=float(rs[i]),
            d=prio.priority_point(float(rs[i]), float(lens[i]), 0.01, None),
            input_len=float(lens[i]), true_out_len=int(us[i]) + 1)
            for i in range(n)])
    return out


def _ids(ts):
    return [t.task for t in ts]


@pytest.mark.parametrize("name", sorted(jsched.POLICIES))
def test_policies_admit_and_select_identical(name):
    jp = jpersonas.get_persona("bart")
    tp = tpersonas.get_persona("bart")
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    jcfg = jsched.PolicyConfig(u_scale=250.0, tau=120.0)
    tcfg = tsched.PolicyConfig(u_scale=250.0, tau=120.0)
    jpol = jsched.POLICIES[name](jp, jcfg)
    tpol = tsched.POLICIES[name](tp, tcfg)
    for seed, n in ((0, 4), (1, 12), (2, 40)):
        jq, tq = _sim_pair(n, seed)
        now = 6.0
        for jt, tt in zip(jq, tq):
            assert jpol.assign_priority(jt) == tpol.assign_priority(tt)
        a = jpol.select(list(jq), now)
        b = tpol.select(list(tq), now)
        assert [_ids(x) for x in a] == [_ids(x) for x in b]
        running_j, running_t = jq[:2], tq[:2]
        a = jpol.admit(list(jq[2:]), now, running_j)
        b = tpol.admit(list(tq[2:]), now, running_t)
        assert (a[0].task if a[0] else None) == (b[0].task if b[0] else None)
        assert a[1] == b[1] and _ids(a[2]) == _ids(b[2])
        assert jpol.max_batch() == tpol.max_batch()


def _drive_chunks(mod, budgets):
    s = mod.ChunkScheduler(chunk_size=5, token_budget=12)
    for j, (total, prio) in enumerate([(17, 1.0), (4, 3.0), (9, 3.0),
                                       (30, 0.5), (1, 2.0)]):
        s.add(f"job{j}", slot=j, total=total, priority=prio)
    trace = []
    for d in budgets:
        plans = s.schedule(d) if s.has_jobs else []
        batch = mod.pack_plans(plans)
        rec = [(p.job.slot, p.start, p.length, p.finishes) for p in plans]
        if batch is not None:
            entries = [(ch.slot, ch.start,
                        np.arange(ch.start, ch.start + ch.length) + 2,
                        np.arange(3) + 10 * ch.slot)
                       for ch in batch.chunks]
            arrays = mod.build_packed_arrays(batch.shape_key, entries,
                                             pad_slot=99, table_width=6,
                                             trash_block=77)
            rec.append((batch.shape_key, [a.tolist() for a in arrays]))
        trace.append(rec)
    return trace


def test_chunk_scheduler_and_packing_identical():
    budgets = [0, 3, 11, 2, 0, 7, 12, 1, 5, 0, 0, 0, 0]
    assert _drive_chunks(jchunk, budgets) == _drive_chunks(tchunk, budgets)
    for n in (1, 3, 17, 64):
        assert jchunk.suffix_shape_key(n) == tchunk.suffix_shape_key(n)


def _drive_allocator(mod):
    a = mod.BlockAllocator(num_blocks=12, block_size=4)
    trace = [a.allocate_n(1, a.blocks_for(9)), a.allocate_n(2, 2),
             a.allocate(1), a.utilization(), a.free_sequence(2),
             a.allocate_n(3, 4), a.table(1), a.table(3), a.num_free,
             a.free_sequence(1), a.allocate(3), a.utilization(),
             a.free_sequence(3), a.num_free]
    a.check_no_leaks()
    return trace


def test_allocator_and_window_targets_identical():
    assert _drive_allocator(jalloc) == _drive_allocator(talloc)
    for args in [(8, g, c, n) for g in range(0, 7) for c in (1, 3, 6)
                 for n in (1, 2, 4)]:
        assert (jalloc.window_target_tokens(*args)
                == talloc.window_target_tokens(*args))
        assert (jalloc.blocks_for_tokens(args[0] + args[1], 4)
                == talloc.blocks_for_tokens(args[0] + args[1], 4))


# ---------------------------------------------------------------------------
# predictor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictors(corpus):
    a, _ = corpus
    jp = jpred.train_predictor(a, "bart", epochs=3, seed=0)
    layers = jax.tree.map(np.asarray, jp.params)
    tp = convert.predictor_from_numpy(layers, jp.mean, jp.std, "cpu")
    return a, jp, tp


def test_predictor_forward_matches(predictors):
    a, jp, tp = predictors
    texts = [t.text for t in a]
    # float32 MLP with 5 layers; sums in another order than XLA's
    np.testing.assert_allclose(tp.score_batch(texts), jp.score_batch(texts),
                               rtol=1e-5, atol=1e-5)
    assert abs(tp.score(texts[0]) - jp.score(texts[0])) < 1e-5 * max(
        1.0, abs(jp.score(texts[0])))


@pytest.mark.parametrize("quantile", [None, 0.9])
def test_predictor_adam_step_matches(predictors, quantile):
    a, jp, tp = predictors
    x, y = jpred.extract_xy(a[:16], "bart")
    xn = ((x - jp.mean) / jp.std).astype(np.float32)
    zeros_j = jax.tree.map(jnp.zeros_like, jp.params)
    pj, _, _, _, lj = jpred._adam_step(
        jp.params, zeros_j, zeros_j, jnp.zeros((), jnp.int32),
        jnp.asarray(xn), jnp.asarray(y), lr=1e-3, quantile=quantile)
    zeros_t = [{k: torch.zeros_like(p[k]) for k in p} for p in tp.params]
    pt, _, _, _, lt = tpred._adam_step(
        tp.params, zeros_t, zeros_t, 0, torch.from_numpy(xn),
        torch.from_numpy(y), lr=1e-3, quantile=quantile)
    # float32 losses of O(1e3..1e4): relative 1e-5
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    # the first Adam step moves each weight by ~lr * sign(g); a gradient
    # that differs in its last float32 bits moves it by the same amount,
    # so the updated weights agree to well within lr / 100
    for lj_, lt_ in zip(pj, pt):
        for k in ("w", "b"):
            np.testing.assert_allclose(lt_[k].numpy(), np.asarray(lj_[k]),
                                       atol=1e-5, rtol=0)


def test_offline_profile_trains_on_given_device(corpus):
    _, b = corpus
    persona = tpersonas.get_persona("bart")
    prof = tsched.offline_profile(b, persona, epochs=2, device="cpu")
    assert prof.predictor.device.type == "cpu"
    assert np.isfinite(prof.tau) and np.isfinite(prof.u_scale)
    assert len(prof.predictor.train_losses) == 2
