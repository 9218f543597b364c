"""PyTorch port: the engine's other rows of the configuration matrix
(docs/ARCHITECTURE.md, "Engine configuration matrix") against the
reference simulator and the JAX engine.

  * ``mode="batch"`` (the defaults) — completion order and dispatch trace
    against ``repro.core.simulator.simulate`` for ``fifo`` and ``rt-lm``
    (tau = 1e18, nothing offloaded); greedy tokens, completion order and
    KV utilization equal to the JAX batch engine's, and with a tau low
    enough to offload, the same bulk-lane task ids and tokens;
  * ``mode="continuous", prefill="stall"`` on the contiguous and the
    paged cache — every scheduling field against ``simulate_continuous``,
    bit for bit, at N in {1, 2, 4} decode steps per window, the tight
    block budget included; greedy tokens equal to the JAX engine's, paged
    equal to contiguous token for token; no block leaks; slots recycled
    at the step they free;
  * validation — every ``ValueError`` row of the reference's constructor
    raises the reference's message; ``serve(step_offset=)`` raises the
    reference's error off the stall loop and, on it, starts the event
    stream at the offset.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro.core import simulator  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

STALL = dict(mode="continuous", prefill="stall")


@pytest.fixture(scope="module")
def setup():
    return es.make_setup()


@pytest.fixture(scope="module")
def serve(setup):
    """Memoized port serves: identical arguments share one serve."""
    memo = {}

    def _serve(policy_name, tau=1e18, **kw):
        key = (policy_name, tau, tuple(sorted(kw.items())))
        if key not in memo:
            eng = es.port_engine(setup, policy_name, tau, **kw)
            memo[key] = (eng, eng.serve(es.requests(tengine,
                                                    setup["texts"])))
        return memo[key]

    return _serve


# ---------------------------------------------------------------------------
# batch mode: the paper's run-to-completion baseline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
def test_batch_mode_vs_sim(setup, serve, policy_name):
    _, res = serve(policy_name)
    sim = simulator.simulate(es.sim_tasks(setup, setup["texts"]),
                             es.jax_policy(setup, policy_name))
    assert res["mode"] == "batch"
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]
    assert res["prefill_dispatches"] == sim.prefill_dispatches
    assert res["prefill_dispatch_trace"] == sim.prefill_dispatch_trace
    for t in res["tasks"]:
        assert t.task.out_len == len(t.task.out_tokens) == es.CAPS[
            t.task.task_id]


@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
def test_batch_mode_matches_jax_engine(setup, serve, policy_name):
    _, res = serve(policy_name)
    want = es.jax_engine(setup, policy_name).serve(
        es.requests(jengine, setup["texts"]))
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    assert res["prefill_dispatch_trace"] == want["prefill_dispatch_trace"]
    assert res["kv_util_peak"] == want["kv_util_peak"]
    assert res["kv_util_mean"] == want["kv_util_mean"]
    assert res["peak_concurrency"] == want["peak_concurrency"]


def test_batch_mode_offload_to_bulk_lane_matches_jax_engine(setup, serve):
    """tau = 0: ``select`` sends the uncertain requests to the bulk lane;
    the same requests must land there, with the same tokens."""
    _, res = serve("rt-lm", tau=0.0)
    want = es.jax_engine(setup, "rt-lm", tau=0.0).serve(
        es.requests(jengine, setup["texts"]))
    bulk = sorted(t.task.task_id for t in res["tasks"]
                  if t.task.lane == "cpu")
    assert bulk, "no request reached the bulk lane"
    assert bulk == sorted(t.task.task_id for t in want["tasks"]
                          if t.task.lane == "cpu")
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)


# ---------------------------------------------------------------------------
# continuous mode, stall admission: contiguous and paged
# ---------------------------------------------------------------------------


def _sim_continuous(s, policy_name, kv, n, **kw):
    if kv == "paged":
        kw = dict(kv_block_size=es.BS, prompt_len=es.BUCKET, **kw)
    return simulator.simulate_continuous(
        es.sim_tasks(s, s["texts"]), es.jax_policy(s, policy_name),
        decode_steps=n, **kw)


@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_stall_vs_sim(setup, serve, kv, n, policy_name):
    kw = dict(kv_block_size=es.BS) if kv == "paged" else {}
    eng, res = serve(policy_name, kv=kv, decode_steps=n, **STALL, **kw)
    if kv == "paged":
        eng.allocator.check_no_leaks()
        sim = _sim_continuous(setup, policy_name, kv, n,
                              num_slots=es.SLOTS,
                              kv_num_blocks=eng.kv_num_blocks)
    else:
        sim = _sim_continuous(setup, policy_name, kv, n)
    assert res["decode_steps_executed"] == n * res["decode_dispatches"]
    es.assert_sim_parity(res, sim)


@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_paged_stall_vs_sim_tight_budget(setup, serve, n, policy_name):
    eng, res = serve(policy_name, kv="paged", kv_block_size=es.BS,
                     decode_steps=n, **STALL, **es.TIGHT)
    eng.allocator.check_no_leaks()
    assert res["rejected_for_memory"] > 0            # the budget binds
    es.assert_sim_parity(res, _sim_continuous(setup, policy_name, "paged",
                                              n, **es.TIGHT))


@pytest.mark.parametrize("kv,n", [("contiguous", 1), ("paged", 2)])
def test_stall_tokens_match_jax_engine(setup, serve, kv, n):
    kw = dict(kv_block_size=es.BS) if kv == "paged" else {}
    eng, res = serve("fifo", kv=kv, decode_steps=n, **STALL, **kw)
    jeng = es.jax_engine(setup, "fifo", kv=kv, decode_steps=n, **STALL,
                         **kw)
    want = jeng.serve(es.requests(jengine, setup["texts"]))
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    assert res["prefill_dispatch_trace"] == want["prefill_dispatch_trace"]
    assert res["kv_util_mean"] == want["kv_util_mean"]
    # the caches the serve leaves behind: the per-slot rings, or the
    # whole page pool (the two allocators hand out the same block ids)
    if kv == "paged":
        es.assert_kv(eng.paged_cache.state["layers"], jeng.paged_cache.state,
                     setup["cfg"])
    else:
        es.assert_kv(eng.slot_cache["layers"], jeng.slot_cache,
                     setup["cfg"])
        for key in ("pos", "slot_pos"):
            assert eng.slot_cache[key].tolist() == \
                np.asarray(jeng.slot_cache[key]).tolist()


@pytest.mark.parametrize("n", [1, 4])
def test_paged_stall_matches_contiguous_token_for_token(serve, n):
    _, cont = serve("rt-lm", kv="contiguous", decode_steps=n, **STALL)
    _, pagd = serve("rt-lm", kv="paged", kv_block_size=es.BS,
                    decode_steps=n, **STALL)
    assert pagd["completion_order"] == cont["completion_order"]
    assert es.tokens(pagd) == es.tokens(cont)
    for t in pagd["tasks"]:
        assert t.task.out_len == es.CAPS[t.task.task_id]
    # the pool holds the same live tokens in fewer reserved blocks
    assert pagd["kv_util_peak"] < cont["kv_util_peak"] == 1.0


def test_paged_stall_returns_every_block(serve):
    eng, res = serve("fifo", kv="paged", kv_block_size=es.BS,
                     decode_steps=1, **STALL)
    assert res["n_tasks"] == len(es.CAPS)
    eng.allocator.check_no_leaks()
    assert eng.allocator.num_free == eng.kv_num_blocks
    assert res["kv"]["kind"] == "paged"
    assert 0.0 < res["kv_util_mean"] <= res["kv_util_peak"] <= 1.0
    assert res["rejected_for_memory"] == 0          # ample default budget
    assert res["exec_cache_hits"] == res["exec_cache_misses"] == 0


def test_slot_recycling(setup):
    """A slot evicted at decode step k is re-admitted at step k, before
    the next window, and the per-slot cache is exposed per slot (the
    reference's tests/test_continuous.py::test_slot_recycling_on_engine,
    with two slots)."""
    caps = [2, 6, 2, 4, 3]
    eng = es.port_engine(setup, "fifo", num_slots=2, **STALL)
    res = eng.serve(es.requests(tengine, setup["texts"], caps))
    assert res["n_tasks"] == len(caps)
    log = eng.admission_log
    assert len(log) == len(caps)
    assert {e["slot"] for e in log} == {0, 1}
    last_free = {}
    for e in log:
        if e["slot"] in last_free:
            assert e["step"] == last_free[e["slot"]]
        last_free[e["slot"]] = e["step"] + (caps[e["task_id"]] - 1)
    assert tuple(eng.slot_cache["pos"].shape) == (2,)
    assert tuple(eng.slot_cache["slot_pos"].shape) == (2, eng.max_len)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(mode="stream"),
    dict(kv="ring"),
    dict(mode="batch", kv="paged"),
    dict(mode="continuous", prefill="eager"),
    dict(mode="continuous", kv="contiguous", prefill="chunked"),
    dict(mode="continuous", kv="contiguous", prefix_cache=True),
    dict(mode="continuous", decode_steps=0),
    dict(mode="batch", decode_steps=2),
    dict(mode="continuous", decode_steps=32),
    dict(mode="continuous", kv="paged", persist_prefix_cache=True),
    dict(mode="continuous", kv="paged", prefill="chunked",
         faults=object()),
    dict(mode="batch", faults=object()),
    dict(mode="continuous", kv="paged", prefill="chunked", chunk_size=0),
    dict(mode="continuous", kv="paged", kv_block_size=4, kv_num_blocks=2),
], ids=["mode", "kv", "batch-paged", "prefill", "contiguous-chunked",
        "contiguous-prefix", "decode_steps-0", "batch-decode_steps",
        "decode_steps-slack", "persist-without-prefix", "faults-chunked",
        "faults-batch", "chunk_size", "deadlock"])
def test_invalid_rows_raise_the_references_error(setup, kw):
    with pytest.raises(ValueError) as want:
        es.jax_engine(setup, "fifo", **kw)
    with pytest.raises(ValueError) as got:
        es.port_engine(setup, "fifo", **kw)
    assert str(got.value) == str(want.value)


def test_step_offset_stays_refused(setup):
    """``serve(step_offset=)`` belongs to the failover rounds of
    ``ReplicatedEngine``: off the continuous stall loop it raises the
    reference's error; on it, the serve's event stream starts at the
    offset and is otherwise the stream of a serve from step 0."""
    reqs = es.requests(tengine, setup["texts"][:1], [1])
    for kw in ({}, dict(mode="continuous", kv="paged", prefill="chunked",
                        kv_block_size=es.BS, chunk_size=es.CHUNK,
                        token_budget=es.BUDGET)):
        with pytest.raises(ValueError) as want:
            es.jax_engine(setup, "fifo", **kw).serve(
                es.requests(jengine, setup["texts"][:1], [1]),
                step_offset=3)
        with pytest.raises(ValueError) as got:
            es.port_engine(setup, "fifo", **kw).serve(reqs, step_offset=3)
        assert str(got.value) == str(want.value)
        assert "continuous stall serve loop" in str(got.value)
    streams, steps = [], []
    for offset in (0, 5):
        ob = tobs.Observability()
        eng = es.port_engine(setup, "fifo", obs=ob, decode_steps=2,
                             **STALL)
        res = eng.serve(es.requests(tengine, setup["texts"][:4],
                                    es.CAPS[:4]), step_offset=offset)
        streams.append(ob.trace.parity_events())
        steps.append((eng.last_step, res["decode_steps_executed"]))
    assert streams[1][0][2] == 5
    assert streams[1] == [(k, tid, None if st is None else st + 5, f)
                          for k, tid, st, f in streams[0]]
    assert steps[1] == (steps[0][0] + 5, steps[0][1])


def test_defaults_serve_the_references_rows(setup, serve):
    """With no ``mode``/``kv``/``prefill`` the port serves the
    reference's defaults (batch, contiguous, stall)."""
    for name in ("mode", "kv", "prefill", "decode_steps", "prefix_cache",
                 "persist_prefix_cache", "input_bucket", "max_new_tokens",
                 "chunk_size", "kv_block_size"):
        assert (inspect.signature(tengine.ServingEngine).parameters[name]
                .default == inspect.signature(jengine.ServingEngine)
                .parameters[name].default)
    eng, res = serve("fifo")
    assert (eng.mode, eng.kv, eng.prefill) == ("batch", "contiguous",
                                               "stall")
    assert res["kv"]["kind"] == "contiguous" and len(res["tasks"]) == len(
        es.CAPS)
