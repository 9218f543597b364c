"""PyTorch port: the serving engine on the recurrent families (the
float32 smoke configs of mamba2-1.3b, ``ssm``, and recurrentgemma-9b,
``hybrid``, with its 64-token local window) in the contiguous rows,
against the reference simulator and the JAX engine.

recurrentgemma's prompts are left-padded to an input bucket of 96, past
its window, so every admission runs the windowed prefill and leaves
wrapped 64-row rings; the pad tokens flow through every conv and
recurrent state, as in the reference.

  * batch mode and continuous stall on the contiguous cache — the
    scheduling fields bit for bit against ``simulate`` /
    ``simulate_continuous``, every request done with its cap, the slot
    cache's state leaves in the reference's dtypes;
  * greedy tokens and completion order equal to the JAX engine's
    (scoring with the port's m_theta), and the caches the stall serve
    leaves behind leaf by leaf (``assert_kv``).  The stall row runs both
    engines on a float32 slot cache: the reference's decode window is a
    ``lax.scan`` whose carry must keep its dtypes, and a float32 model's
    conv tail leaves its bf16 default cache as float32, so the JAX
    engine serves a float32 recurrent model only on a float32 slot cache
    (ROADMAP Queue 3 entry R3); the port rounds the tail into the cache's
    own dtype at every step;
  * the paged rows refuse both families with the reference's exception
    and message (``transformer.paged_supported``).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro.core import simulator  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

#: model -> input bucket: recurrentgemma's past its window of 64
BUCKETS = {"mamba2-1.3b": es.BUCKET, "recurrentgemma-9b": 96}
ROWS = {"batch": {}, "contiguous-stall": dict(mode="continuous",
                                              decode_steps=2)}


@pytest.fixture(scope="module")
def setups():
    """One setup (corpus, personas, m_theta) for both models."""
    memo = {}

    def get(name):
        if not memo:
            memo[name] = es.make_setup(name)
        elif name not in memo:
            memo[name] = {**next(iter(memo.values())), **es.models(name)}
        return memo[name]

    return get


def _engines(s, name, row, make):
    return make(s, "rt-lm", input_bucket=BUCKETS[name], **ROWS[row])


@pytest.fixture(scope="module")
def served(setups):
    """The port's serve of a row with the default caches, once."""
    memo = {}

    def _served(name, row):
        if (name, row) not in memo:
            s = setups(name)
            eng = _engines(s, name, row, es.port_engine)
            memo[name, row] = (eng, eng.serve(es.requests(tengine,
                                                          s["texts"])))
        return memo[name, row]

    return _served


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("name", list(BUCKETS))
def test_recurrent_row_vs_sim(setups, served, name, row):
    s = setups(name)
    eng, res = served(name, row)
    tasks = es.sim_tasks(s, s["texts"])
    policy = es.jax_policy(s, "rt-lm")
    if row == "batch":
        sim = simulator.simulate(tasks, policy)
        assert res["completion_order"] == [t.task.task_id
                                           for t in sim.tasks]
        assert res["prefill_dispatch_trace"] == sim.prefill_dispatch_trace
    else:
        es.assert_sim_parity(res, simulator.simulate_continuous(
            tasks, policy, decode_steps=2))
        cache = eng.slot_cache
        cap = 1 if s["cfg"].family == "ssm" else s["cfg"].local_window
        assert tuple(cache["slot_pos"].shape) == (es.SLOTS, cap)
        for kind, lc in zip(tt.layer_kinds(s["cfg"]), cache["layers"]):
            want = {"ssm": {"conv": torch.bfloat16, "ssd": torch.float32},
                    "rec": {"conv": torch.bfloat16, "h": torch.float32}}.get(
                kind, {"k": torch.bfloat16, "v": torch.bfloat16})
            assert {k: v.dtype for k, v in lc.items()} == want
    for t in res["tasks"]:
        assert t.task.out_len == len(t.task.out_tokens) == es.CAPS[
            t.task.task_id]


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("name", list(BUCKETS))
def test_recurrent_row_tokens_match_jax_engine(setups, served, name, row):
    s = setups(name)
    with pytest.MonkeyPatch.context() as mp:
        if row == "batch":
            eng, res = served(name, row)
        else:
            mp.setattr(jt, "init_slot_cache", functools.partial(
                jt.init_slot_cache, dtype=jnp.float32))
            mp.setattr(tt, "init_slot_cache", functools.partial(
                tt.init_slot_cache, dtype=torch.float32))
            eng = _engines(s, name, row, es.port_engine)
            res = eng.serve(es.requests(tengine, s["texts"]))
        jeng = _engines(s, name, row, es.jax_engine)
        jeng.profile = dataclasses.replace(
            jeng.profile, predictor=es.PortScores(s["tprof"].predictor))
        want = jeng.serve(es.requests(jengine, s["texts"]))
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    if row != "batch":
        es.assert_kv(eng.slot_cache["layers"], jeng.slot_cache, s["cfg"])
        for key in ("pos", "slot_pos"):
            np.testing.assert_array_equal(
                eng.slot_cache[key].numpy(), np.asarray(jeng.slot_cache[key]))


@pytest.mark.parametrize("name", list(BUCKETS))
def test_paged_rows_refuse_recurrent_families(setups, name):
    s = setups(name)
    for kw in (dict(prefill="stall"), dict(prefill="chunked",
                                           chunk_size=es.CHUNK)):
        kw = dict(mode="continuous", kv="paged", kv_block_size=es.BS,
                  input_bucket=BUCKETS[name], **kw)
        with pytest.raises(Exception) as want:
            es.jax_engine(s, "fifo", **kw)
        with pytest.raises(Exception) as got:
            es.port_engine(s, "fifo", **kw)
        assert type(got.value) is type(want.value) is NotImplementedError
        assert str(got.value) == str(want.value)
        assert f"family {s['cfg'].family!r}" in str(got.value)
