"""PyTorch port: the serving engine on sliding-window models (the float32
smoke configs of h2o-danube-3-4b, dense, and mixtral-8x22b, MoE, both
with window 64) in the contiguous rows, against the reference simulator
and the JAX engine.

Prompts are left-padded to an input bucket of 96, past the window, so
every prefill runs the windowed attention and leaves a wrapped ring of 64
rows, on which the decode windows run.

  * batch mode and continuous stall on the contiguous ring — the
    scheduling fields bit for bit against ``simulate`` /
    ``simulate_continuous``, greedy tokens and completion order equal to
    the JAX engine's (scoring with the port's m_theta), and the rings the
    stall serve leaves behind within two bf16 ulps of the JAX engine's;
  * the paged rows refuse a window with the reference's exception and
    message (``transformer.paged_supported``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro.core import simulator  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

BUCKET = 96                  # past the smoke configs' window of 64
NAMES = ["h2o-danube-3-4b", "mixtral-8x22b"]
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


@pytest.fixture(scope="module")
def served(setups):
    memo = {}

    def _served(name, row):
        if (name, row) not in memo:
            eng = es.port_engine(setups(name), "rt-lm",
                                 input_bucket=BUCKET, **ROWS[row])
            memo[name, row] = (eng, eng.serve(es.requests(
                tengine, setups(name)["texts"])))
        return memo[name, row]

    return _served


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("name", NAMES)
def test_window_row_vs_sim(setups, served, name, row):
    s = setups(name)
    eng, res = served(name, row)
    assert eng.cfg.window < BUCKET
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
        assert tuple(eng.slot_cache["slot_pos"].shape) == (
            es.SLOTS, eng.cfg.window)
    for t in res["tasks"]:
        assert t.task.out_len == len(t.task.out_tokens) == es.CAPS[
            t.task.task_id]


@pytest.mark.parametrize("row", list(ROWS))
@pytest.mark.parametrize("name", NAMES)
def test_window_row_tokens_match_jax_engine(setups, served, name, row):
    s = setups(name)
    eng, res = served(name, row)
    jeng = es.jax_engine(s, "rt-lm", input_bucket=BUCKET, **ROWS[row])
    jeng.profile = dataclasses.replace(
        jeng.profile, predictor=es.PortScores(s["tprof"].predictor))
    want = jeng.serve(es.requests(jengine, s["texts"]))
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    if row == "contiguous-stall":
        es.assert_kv(eng.slot_cache["layers"], jeng.slot_cache, s["cfg"])
        for key in ("pos", "slot_pos"):
            np.testing.assert_array_equal(
                eng.slot_cache[key].numpy(), np.asarray(jeng.slot_cache[key]))


@pytest.mark.parametrize("name", NAMES)
def test_paged_rows_refuse_a_window(setups, name):
    s = setups(name)
    for kw in (dict(prefill="stall"), dict(prefill="chunked",
                                           chunk_size=es.CHUNK)):
        kw = dict(mode="continuous", kv="paged", kv_block_size=es.BS, **kw)
        with pytest.raises(Exception) as want:
            es.jax_engine(s, "fifo", input_bucket=BUCKET, **kw)
        with pytest.raises(Exception) as got:
            es.port_engine(s, "fifo", input_bucket=BUCKET, **kw)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
        assert "sliding-window" in str(got.value)
