"""PyTorch port: the serving engine against the reference simulator and
the JAX engine.

  * engine vs ``repro.core.simulator.simulate_continuous`` — bit for bit
    on completion order, rejections, KV utilization, ``budget_trace``,
    both dispatch traces and the fused launch's shape-key counters, at
    N in {1, 2, 4} decode steps per window, for ``fifo`` and ``rt-lm``
    (tau = 1e18, so nothing is offloaded), including the tight block
    budget of tests/test_chunked_prefill.py where rejections bind;
  * engine vs ``repro.serving.engine.ServingEngine`` — identical greedy
    tokens on the same float32 smoke workload, and, with a tau low enough
    to offload, the same bulk-lane task ids and tokens;
  * refusals — what the slice does not port raises ``NotImplementedError``
    naming its ROADMAP item, and no card without ``device="cpu"`` raises;
  * ``CompletionWorker`` — FIFO results and error propagation.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs  # noqa: E402
from repro.core import datagen, personas  # noqa: E402
from repro.core import priority as jprio  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import simulator  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.core import personas as tpersonas  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from repro_torch.serving.pipeline import CompletionWorker  # noqa: E402

SLOTS = 3
MAX_NEW = 6
BUCKET = 8
BS = 4
CAPS = [2, 6, 1, 4, 6, 2, 3, 5, 1, 6, 2, 4]
CHUNK = 3
BUDGET = 8
TIGHT = dict(num_slots=4, kv_num_blocks=7)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(configs.get_smoke_config("starcoder2-3b"),
                              param_dtype="float32",
                              compute_dtype="float32")
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    corpus = datagen.generate_corpus(datagen.VARIANCE_MIXES["normal"], 64,
                                     seed=0)
    train, test = datagen.train_test_split(corpus, train_frac=0.5)
    jpersona = dataclasses.replace(personas.get_persona("bart"),
                                   batch_size=SLOTS)
    tpersona = dataclasses.replace(tpersonas.get_persona("bart"),
                                   batch_size=SLOTS)
    jprof = jsched.offline_profile(train, jpersona, epochs=15)
    pred = jprof.predictor
    tprof = tsched.OfflineProfile(
        predictor=convert.predictor_from_numpy(
            jax.tree.map(np.asarray, pred.params), pred.mean, pred.std,
            "cpu"),
        tau=jprof.tau, u_scale=jprof.u_scale, persona_name="bart")
    return dict(cfg=cfg, jp=jp, tp=tp, test=test, jpersona=jpersona,
                tpersona=tpersona, jprof=jprof, tprof=tprof)


def _requests(mod, test, caps=CAPS):
    return [mod.Request(text=t.text, arrival=0.0, task_id=i,
                        max_new_tokens=c)
            for i, (t, c) in enumerate(zip(test, caps))]


def _engine_kw(n, **kw):
    return dict(input_bucket=BUCKET, max_new_tokens=MAX_NEW,
                mode="continuous", eos_id=-1, kv="paged", kv_block_size=BS,
                prefill="chunked", chunk_size=CHUNK, token_budget=BUDGET,
                decode_steps=n, **kw)


def _port_engine(s, policy_name, n, tau=1e18, **kw):
    pcfg = dataclasses.replace(s["tprof"].policy_config(), tau=tau)
    return tengine.ServingEngine(
        s["tp"], s["cfg"],
        tsched.POLICIES[policy_name](s["tpersona"], pcfg), s["tprof"],
        device="cpu", **_engine_kw(n, **kw))


def _jax_engine(s, policy_name, n, tau=1e18, **kw):
    pcfg = dataclasses.replace(s["jprof"].policy_config(), tau=tau)
    return jengine.ServingEngine(
        s["jp"], s["cfg"],
        jsched.POLICIES[policy_name](s["jpersona"], pcfg), s["jprof"],
        **_engine_kw(n, **kw))


@pytest.fixture(scope="module")
def serve(setup):
    """Memoized port serves: identical arguments share one serve."""
    memo = {}

    def _serve(policy_name, n, tau=1e18, **kw):
        key = (policy_name, n, tau, tuple(sorted(kw.items())))
        if key not in memo:
            eng = _port_engine(setup, policy_name, n, tau, **kw)
            memo[key] = (eng, eng.serve(_requests(tengine, setup["test"])))
        return memo[key]

    return _serve


def _sim(s, policy_name, n, **kw):
    """The simulator fed the port's own u (its m_theta carries the
    reference weights), so a last-bit float difference between the two
    MLPs can never reorder the queue."""
    pred = s["tprof"].predictor
    tasks = []
    for i, (t, c) in enumerate(zip(s["test"], CAPS)):
        d = jprio.priority_point(0.0, len(t.text.split()),
                                 s["jpersona"].phi, None, xi=2.0)
        tasks.append(jprio.SimTask(
            task=jengine.Request(text=t.text, arrival=0.0, task_id=i),
            u=float(max(pred.score(t.text), 0.0)), r=0.0, d=d,
            input_len=float(len(t.text.split())), true_out_len=int(c)))
    pcfg = dataclasses.replace(s["jprof"].policy_config(), tau=1e18)
    return simulator.simulate_continuous(
        tasks, jsched.POLICIES[policy_name](s["jpersona"], pcfg),
        kv_block_size=BS, prompt_len=BUCKET, prefill="chunked",
        chunk_size=CHUNK, token_budget=BUDGET, decode_steps=n, **kw)


def _assert_sim_parity(res, sim):
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]
    assert res["rejected_for_memory"] == sim.kv_rejected
    assert res["budget_trace"] == sim.budget_trace
    assert res["prefill_dispatches"] == sim.prefill_dispatches
    assert res["prefill_dispatch_trace"] == sim.prefill_dispatch_trace
    assert all(x <= 1 for x in res["prefill_dispatch_trace"])
    assert res["exec_cache_hits"] == sim.exec_cache_hits
    assert res["exec_cache_misses"] == sim.exec_cache_misses
    assert res["decode_dispatches"] == sim.decode_dispatches
    assert res["decode_steps_executed"] == sim.decode_steps_executed
    assert res["decode_dispatch_trace"] == sim.decode_dispatch_trace
    assert res["kv_util_peak"] == sim.kv_util_peak
    assert res["kv_util_mean"] == sim.kv_util_mean


@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_engine_vs_sim_tight_budget(setup, serve, policy_name, n):
    eng, res = serve(policy_name, n, **TIGHT)
    eng.allocator.check_no_leaks()
    assert res["rejected_for_memory"] > 0            # the budget binds
    assert res["decode_steps_executed"] == n * res["decode_dispatches"]
    _assert_sim_parity(res, _sim(setup, policy_name, n, **TIGHT))


@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
def test_engine_vs_sim_default_budget(setup, serve, policy_name):
    eng, res = serve(policy_name, 4)
    _assert_sim_parity(res, _sim(setup, policy_name, 4, num_slots=SLOTS,
                                 kv_num_blocks=eng.kv_num_blocks))


def _tokens(res):
    return {t.task.task_id: list(t.task.out_tokens) for t in res["tasks"]}


@pytest.mark.parametrize("policy_name,n", [("fifo", 2), ("rt-lm", 4)])
def test_greedy_tokens_match_jax_engine(setup, serve, policy_name, n):
    _, res = serve(policy_name, n, **TIGHT)
    want = _jax_engine(setup, policy_name, n, **TIGHT).serve(
        _requests(jengine, setup["test"]))
    assert res["completion_order"] == want["completion_order"]
    assert _tokens(res) == _tokens(want)
    assert res["budget_trace"] == want["budget_trace"]
    for t in res["tasks"]:
        assert len(t.task.out_tokens) == t.task.out_len == CAPS[
            t.task.task_id]


def test_offload_to_bulk_lane_matches_jax_engine(setup, serve):
    """tau = 0: under congestion every front-runner with u > 0 goes to the
    bulk lane; the same requests must land there, with the same tokens."""
    _, res = serve("rt-lm", 1, tau=0.0)
    want = _jax_engine(setup, "rt-lm", 1, tau=0.0).serve(
        _requests(jengine, setup["test"]))
    bulk = sorted(t.task.task_id for t in res["tasks"]
                  if t.task.lane == "cpu")
    assert bulk, "no request reached the bulk lane"
    assert bulk == sorted(t.task.task_id for t in want["tasks"]
                          if t.task.lane == "cpu")
    assert _tokens(res) == _tokens(want)
    assert len(res["tasks"]) == len(CAPS)


def test_tail_metrics_reported(serve):
    _, res = serve("fifo", 2, **TIGHT)
    for key in ("ttft_p50", "ttft_p99", "itl_p50", "itl_p99",
                "queue_wait_p50", "mean_response_s"):
        assert np.isfinite(res[key]) and res[key] >= 0.0
    assert res["ttft_p50"] <= res["ttft_p99"] + 1e-12
    for t in res["tasks"]:
        times = t.task.token_times
        assert len(times) == t.task.out_len
        assert all(b >= a - 1e-9 for a, b in zip(times, times[1:]))


# ---------------------------------------------------------------------------
# refusals and device rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,item", [
    (dict(mode="batch"), "Queue 1 item 6"),
    (dict(kv="contiguous"), "Queue 1 item 6"),
    (dict(prefill="stall"), "Queue 1 item 6"),
    (dict(prefix_cache=True), "Queue 1 item 6"),
    (dict(persist_prefix_cache=True), "Queue 1 item 6"),
    (dict(faults=object()), "Queue 1 item 8"),
    (dict(obs=object()), "Queue 1 item 7"),
])
def test_unported_options_are_refused(setup, kw, item):
    base = _engine_kw(1)
    base.update(kw)
    pcfg = setup["tprof"].policy_config()
    with pytest.raises(NotImplementedError, match=item):
        tengine.ServingEngine(
            setup["tp"], setup["cfg"],
            tsched.POLICIES["fifo"](setup["tpersona"], pcfg),
            setup["tprof"], device="cpu", **base)


def test_other_families_are_refused(setup):
    cfg = configs.get_smoke_config("mamba2-1.3b")
    pcfg = setup["tprof"].policy_config()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tengine.ServingEngine(
            setup["tp"], cfg,
            tsched.POLICIES["fifo"](setup["tpersona"], pcfg),
            setup["tprof"], device="cpu", **_engine_kw(1))


def test_no_card_raises_unless_cpu_is_asked_for(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = setup["tprof"].policy_config()
    policy = tsched.POLICIES["fifo"](setup["tpersona"], pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ServingEngine(setup["tp"], setup["cfg"], policy,
                              setup["tprof"], **_engine_kw(1))
    eng = tengine.ServingEngine(setup["tp"], setup["cfg"], policy,
                                setup["tprof"], device="cpu",
                                **_engine_kw(1))
    assert eng.device.type == "cpu" and eng.use_kernels is False


# ---------------------------------------------------------------------------
# completion worker
# ---------------------------------------------------------------------------


class _Boom(torch.Tensor):
    pass


def test_completion_worker_fifo_and_errors():
    with CompletionWorker() as w:
        for i in range(5):
            w.submit(torch.full((2, 3), i, dtype=torch.int32), 0.0)
        for i in range(5):
            host, dt = w.collect()
            assert isinstance(host, np.ndarray)
            np.testing.assert_array_equal(host, np.full((2, 3), i))
            assert dt > 0.0
        w.submit(torch.zeros(2, dtype=torch.bfloat16), 0.0)  # no numpy bf16
        with pytest.raises(TypeError):
            w.collect()
        w.submit(torch.ones(1), 0.0)           # the worker survives it
        assert w.collect()[0].tolist() == [1.0]
    assert not any(t.name == "completion-worker" and t.is_alive()
                   for t in threading.enumerate())
