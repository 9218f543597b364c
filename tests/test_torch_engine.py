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
  * the same greedy-token parity on the two other dense full-attention
    smoke configs, yi-6b (swiglu, untied ``lm_head``) and minitron-4b
    (relu, untied);
  * refusals — what is not ported yet raises ``NotImplementedError``
    naming its ROADMAP item, the defaults are the reference's and serve,
    and no card without ``device="cpu"`` raises; a fault plan is accepted
    on both stall caches;
  * ``CompletionWorker`` — FIFO results and error propagation.
"""

import dataclasses
import inspect
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
from repro_torch.serving.faults import ReplicaFaults  # noqa: E402
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


def _dense_setup(s, name):
    """``setup`` with another dense smoke config's weights (the corpus,
    personas and m_theta stay)."""
    cfg = dataclasses.replace(configs.get_smoke_config(name),
                              param_dtype="float32",
                              compute_dtype="float32")
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return {**s, "cfg": cfg, "jp": jp, "tp": tp}


@pytest.mark.parametrize("name,policy_name,n", [
    pytest.param("starcoder2-3b", "fifo", 2, id="fifo-2"),
    pytest.param("starcoder2-3b", "rt-lm", 4, id="rt-lm-4"),
    pytest.param("yi-6b", "rt-lm", 4, id="yi-6b-rt-lm-4"),
    pytest.param("minitron-4b", "fifo", 2, id="minitron-4b-fifo-2"),
])
def test_greedy_tokens_match_jax_engine(setup, serve, name, policy_name, n):
    if name == "starcoder2-3b":
        s = setup
        _, res = serve(policy_name, n, **TIGHT)
    else:
        s = _dense_setup(setup, name)
        res = _port_engine(s, policy_name, n, **TIGHT).serve(
            _requests(tengine, s["test"]))
    want = _jax_engine(s, policy_name, n, **TIGHT).serve(
        _requests(jengine, s["test"]))
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


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_unported_options_are_refused(setup, kv):
    """Fault plans are ported: a ``ReplicaFaults`` plan is accepted on the
    continuous stall loop of either cache, and a serve under an empty plan
    reports the fault keys with nothing dropped."""
    base = _engine_kw(1)
    base.update(prefill="stall", kv=kv)
    pcfg = dataclasses.replace(setup["tprof"].policy_config(), tau=1e18)
    rf = ReplicaFaults()
    eng = tengine.ServingEngine(
        setup["tp"], setup["cfg"],
        tsched.POLICIES["fifo"](setup["tpersona"], pcfg),
        setup["tprof"], device="cpu", faults=rf, **base)
    assert eng.faults is rf
    res = eng.serve(_requests(tengine, setup["test"][:2]))
    assert len(res["tasks"]) == 2
    assert (res["timed_out"], res["shed"], res["crashed"]) == (0, 0, False)
    assert res["survivor_ids"] == [] and res["final_step"] == eng.last_step
    assert res["final_step"] == res["decode_steps_executed"] > 0


def test_defaults_are_the_references_and_are_refused(setup):
    """``mode``, ``kv`` and ``prefill`` default to the reference's values
    (batch, contiguous, stall), and a call that relies on the defaults
    serves that row: the same completion order and tokens as the JAX
    engine's defaults."""
    for name in ("mode", "kv", "prefill"):
        assert (inspect.signature(tengine.ServingEngine).parameters[name]
                .default == inspect.signature(jengine.ServingEngine)
                .parameters[name].default)
    pcfg = dataclasses.replace(setup["tprof"].policy_config(), tau=1e18)
    eng = tengine.ServingEngine(
        setup["tp"], setup["cfg"],
        tsched.POLICIES["fifo"](setup["tpersona"], pcfg),
        setup["tprof"], input_bucket=BUCKET, max_new_tokens=MAX_NEW,
        eos_id=-1, device="cpu")
    assert (eng.mode, eng.kv, eng.prefill) == ("batch", "contiguous",
                                               "stall")
    res = eng.serve(_requests(tengine, setup["test"]))
    jpcfg = dataclasses.replace(setup["jprof"].policy_config(), tau=1e18)
    want = jengine.ServingEngine(
        setup["jp"], setup["cfg"],
        jsched.POLICIES["fifo"](setup["jpersona"], jpcfg), setup["jprof"],
        input_bucket=BUCKET, max_new_tokens=MAX_NEW, eos_id=-1).serve(
            _requests(jengine, setup["test"]))
    assert res["mode"] == want["mode"] == "batch"
    assert res["completion_order"] == want["completion_order"]
    assert _tokens(res) == _tokens(want)


@pytest.mark.parametrize("name,key", [("llava-next-mistral-7b", "patches"),
                                      ("seamless-m4t-large-v2", "frames")])
def test_other_families_are_refused(setup, name, key):
    """The vlm and encdec families are served at model level only
    (ROADMAP Queue 3 entry R4): the port's engine refuses them when it is
    built, on the default row and on the paged one; the reference's engine
    builds and fails at its first prefill, whose batch holds tokens only
    (``_decoder_inputs`` reads ``batch["patches"]`` / ``["frames"]``)."""
    cfg = configs.get_smoke_config(name)
    pcfg = setup["tprof"].policy_config()
    for kw in ({}, _engine_kw(1)):
        with pytest.raises(NotImplementedError,
                           match="Queue 3 entry R4") as got:
            tengine.ServingEngine(
                setup["tp"], cfg,
                tsched.POLICIES["fifo"](setup["tpersona"], pcfg),
                setup["tprof"], device="cpu", **kw)
        assert key in str(got.value)
    jpcfg = setup["jprof"].policy_config()
    eng = jengine.ServingEngine(
        jm.init_params(jax.random.PRNGKey(0), cfg), cfg,
        jsched.POLICIES["fifo"](setup["jpersona"], jpcfg), setup["jprof"],
        input_bucket=BUCKET, max_new_tokens=2, eos_id=-1)
    with pytest.raises(KeyError, match=key):
        eng.serve(_requests(jengine, setup["test"][:2], caps=[2, 2]))


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
