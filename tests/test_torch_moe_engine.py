"""PyTorch port: the serving engine on a MoE model (the float32
kimi-k2-1t-a32b smoke config: a dense prefix layer, then a MoE layer of 4
experts top-2 with a shared expert) in every row of the configuration
matrix, against the reference simulator and the JAX engine.

  * rows — batch mode; continuous stall on the contiguous ring and on the
    paged pool; paged stall with the prefix cache; continuous chunked
    prefill on the paged pool with the tight block budget (the fused
    ragged prefill routes its padded packed stream through the MoE layer);
    chunked prefill with the persistent prefix cache, served twice;
  * every scheduling-determined field bit for bit against ``simulate`` /
    ``simulate_continuous`` (the simulator fed the port's own ``u``);
  * greedy tokens and completion order equal to the JAX engine's, which
    scores with the port's m_theta (ROADMAP Queue 3 entry 11), and no
    block leaked.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro.core import simulator  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

PAGED = dict(mode="continuous", kv="paged", kv_block_size=es.BS)
CHUNKED = dict(prefill="chunked", chunk_size=es.CHUNK,
               token_budget=es.BUDGET)
# row -> (engine arguments, shared-prefix workload, serves)
ROWS = {
    "batch": ({}, False, 1),
    "contiguous-stall": (dict(mode="continuous", decode_steps=2), False, 1),
    "paged-stall": (dict(PAGED, decode_steps=2), False, 1),
    "paged-stall-prefix": (dict(PAGED, prefix_cache=True, decode_steps=2),
                           True, 1),
    "chunked": (dict(PAGED, decode_steps=4, **CHUNKED, **es.TIGHT), False,
                1),
    "chunked-persist": (dict(PAGED, prefix_cache=True,
                             persist_prefix_cache=True, **CHUNKED), True, 2),
}


@pytest.fixture(scope="module")
def setup():
    s = es.make_setup("kimi-k2-1t-a32b")
    corpus = s["texts"]
    words = [(t.split() * 2)[:4] for t in corpus[:5]]
    # tests/test_torch_prefix.py's shared-prefix workload
    s["prefix_texts"] = [corpus[i] if i % 4 == 0 else
                         " ".join(["shared", "system", "prompt", "here"]
                                  + words[i % 5])
                         for i in range(len(es.CAPS))]
    return s


def _texts(s, row):
    return s["prefix_texts"] if ROWS[row][1] else s["texts"]


def _serves(eng, mod, texts, n):
    return [eng.serve(es.requests(mod, texts)) for _ in range(n)]


@pytest.fixture(scope="module")
def served(setup):
    """Memoized port serves, one engine per row."""
    memo = {}

    def _served(row):
        if row not in memo:
            kw, _, n = ROWS[row]
            eng = es.port_engine(setup, "rt-lm", **kw)
            memo[row] = (eng, _serves(eng, tengine, _texts(setup, row), n))
        return memo[row]

    return _served


def _sims(s, row, eng):
    kw, prefix, n = ROWS[row]
    tasks = lambda: es.sim_tasks(s, _texts(s, row))  # noqa: E731
    policy = es.jax_policy(s, "rt-lm")
    if row == "batch":
        return [simulator.simulate(tasks(), policy)]
    skw = dict(decode_steps=kw.get("decode_steps", 1))
    if kw.get("kv") == "paged":
        skw.update(kv_block_size=es.BS, prompt_len=es.BUCKET,
                   num_slots=eng.num_slots, kv_num_blocks=eng.kv_num_blocks)
    if kw.get("prefill") == "chunked":
        skw.update(prefill="chunked", chunk_size=es.CHUNK,
                   token_budget=es.BUDGET)
    if prefix:
        skw.update(prefix_cache=True,
                   prompt_tokens=es.prompt_tokens_fn(s["cfg"]))
    if n > 1:
        skw["prefix_state"] = simulator.make_prefix_state(eng.kv_num_blocks,
                                                          es.BS)
    return [simulator.simulate_continuous(tasks(), policy, **skw)
            for _ in range(n)]


@pytest.mark.parametrize("row", list(ROWS))
def test_row_vs_sim(setup, served, row):
    eng, results = served(row)
    for res, sim in zip(results, _sims(setup, row, eng)):
        assert res["completion_order"] == [t.task.task_id
                                           for t in sim.tasks]
        assert res["prefill_dispatch_trace"] == sim.prefill_dispatch_trace
        if row != "batch":
            es.assert_sim_parity(res, sim)
        for t in res["tasks"]:
            assert t.task.out_len == len(t.task.out_tokens) == es.CAPS[
                t.task.task_id]
    if ROWS[row][0].get("kv") == "paged":
        if eng.prefix_cache is not None:
            eng.prefix_cache.clear()
        eng.allocator.check_no_leaks()
    if row == "chunked":
        assert results[0]["rejected_for_memory"] > 0   # the budget binds
    if ROWS[row][1]:
        assert results[-1]["cow_copies"] > 0


@pytest.mark.parametrize("row", list(ROWS))
def test_row_tokens_match_jax_engine(setup, served, row):
    kw, _, n = ROWS[row]
    _, results = served(row)
    jeng = es.jax_engine(setup, "rt-lm", **kw)
    jeng.profile = dataclasses.replace(
        jeng.profile, predictor=es.PortScores(setup["tprof"].predictor))
    wants = _serves(jeng, jengine, _texts(setup, row), n)
    for res, want in zip(results, wants):
        assert res["completion_order"] == want["completion_order"]
        assert es.tokens(res) == es.tokens(want)
        assert res["prefill_dispatch_trace"] == want["prefill_dispatch_trace"]
