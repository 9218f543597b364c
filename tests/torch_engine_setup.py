"""Shared setup of the PyTorch port's engine parity tests
(``tests/test_torch_engine_modes.py``, ``tests/test_torch_prefix.py``,
``tests/test_torch_moe_engine.py``, ``tests/test_torch_window_engine.py``,
``tests/test_torch_recurrent_engine.py`` and others).

One float32 smoke model (starcoder2-3b unless another is named) in both
frameworks (the port's weights are the
reference's, copied bit for bit), an m_theta trained by the reference and
carried into the port, the test corpus, and helpers that make requests,
engines and simulator tasks.  The simulator is fed the port's own ``u``, so a
last-bit float difference between the two MLPs can never reorder a queue.
"""

import dataclasses

import jax
import numpy as np
import torch

from repro import configs
from repro.core import datagen, personas
from repro.core import priority as jprio
from repro.core import scheduler as jsched
from repro.models import model as jm
from repro.serving import engine as jengine
from repro_torch.core import personas as tpersonas
from repro_torch.core import scheduler as tsched
from repro_torch.models import convert
from repro_torch.serving import engine as tengine

SLOTS = 3
MAX_NEW = 6
BUCKET = 8
BS = 4
CAPS = [2, 6, 1, 4, 6, 2, 3, 5, 1, 6, 2, 4]
CHUNK = 3
BUDGET = 8
# a pool too small for every sequence at once: worst case
# ceil((8 + 5) / 4) = 4 of 7 blocks, so the admission gate binds
TIGHT = dict(num_slots=4, kv_num_blocks=7)


def cfg32(name: str = "starcoder2-3b"):
    return dataclasses.replace(configs.get_smoke_config(name),
                               param_dtype="float32",
                               compute_dtype="float32")


def models(name: str) -> dict:
    """One float32 smoke model in both frameworks: ``cfg``, ``jp``,
    ``tp``."""
    cfg = cfg32(name)
    jp = jm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return dict(cfg=cfg, jp=jp, tp=tp)


def make_setup(name: str = "starcoder2-3b") -> dict:
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
    return dict(models(name), texts=[t.text for t in test],
                jpersona=jpersona, tpersona=tpersona, jprof=jprof,
                tprof=tprof)


def requests(mod, texts, caps=CAPS, classes=None):
    """All at t = 0; ``classes``: a traffic class per request."""
    classes = classes or [""] * len(texts)
    return [mod.Request(text=t, arrival=0.0, task_id=i, max_new_tokens=c,
                        traffic_class=k)
            for i, (t, c, k) in enumerate(zip(texts, caps, classes))]


def port_policy(s, name: str, tau: float = 1e18):
    pcfg = dataclasses.replace(s["tprof"].policy_config(), tau=tau)
    return tsched.POLICIES[name](s["tpersona"], pcfg)


def jax_policy(s, name: str, tau: float = 1e18):
    pcfg = dataclasses.replace(s["jprof"].policy_config(), tau=tau)
    return jsched.POLICIES[name](s["jpersona"], pcfg)


class PortScores:
    """The port's m_theta in the reference profile's predictor slot."""

    def __init__(self, predictor):
        self.predictor = predictor

    def score(self, text: str) -> float:
        return self.predictor.score(text)


def port_engine(s, policy_name: str, tau: float = 1e18, **kw):
    kw = {"input_bucket": BUCKET, "max_new_tokens": MAX_NEW, "eos_id": -1,
          **kw}
    return tengine.ServingEngine(s["tp"], s["cfg"],
                                 port_policy(s, policy_name, tau),
                                 s["tprof"], device="cpu", **kw)


def jax_engine(s, policy_name: str, tau: float = 1e18, **kw):
    kw = {"input_bucket": BUCKET, "max_new_tokens": MAX_NEW, "eos_id": -1,
          **kw}
    return jengine.ServingEngine(s["jp"], s["cfg"],
                                 jax_policy(s, policy_name, tau),
                                 s["jprof"], **kw)


def sim_tasks(s, texts, caps=CAPS, classes=None):
    """``ServingEngine._to_sim_task`` with the output length the engine
    realises (EOS disabled, cap = exact length)."""
    pred = s["tprof"].predictor
    classes = classes or [""] * len(texts)
    out = []
    for i, (t, c, k) in enumerate(zip(texts, caps, classes)):
        d = jprio.priority_point(0.0, len(t.split()), s["jpersona"].phi,
                                 None, xi=2.0)
        out.append(jprio.SimTask(
            task=jengine.Request(text=t, arrival=0.0, task_id=i,
                                 traffic_class=k),
            u=float(max(pred.score(t), 0.0)), r=0.0, d=d,
            input_len=float(len(t.split())), true_out_len=int(c)))
    return out


def prompt_tokens_fn(cfg, bucket: int = BUCKET):
    """The engine's admission bucket, for
    ``simulate_continuous(prompt_tokens=...)``."""
    def fn(task):
        return jengine.tokenize_padded(task.task.text, cfg.vocab_size,
                                       bucket)
    return fn


def tokens(res) -> dict:
    return {t.task.task_id: list(t.task.out_tokens) for t in res["tasks"]}


def assert_sim_parity(res, sim):
    """Every scheduling-determined field, bit for bit."""
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]
    assert res["rejected_for_memory"] == sim.kv_rejected
    assert res["budget_trace"] == sim.budget_trace
    assert res["prefill_dispatches"] == sim.prefill_dispatches
    assert res["prefill_dispatch_trace"] == sim.prefill_dispatch_trace
    assert res["exec_cache_hits"] == sim.exec_cache_hits
    assert res["exec_cache_misses"] == sim.exec_cache_misses
    assert res["decode_dispatches"] == sim.decode_dispatches
    assert res["decode_steps_executed"] == sim.decode_steps_executed
    assert res["decode_dispatch_trace"] == sim.decode_dispatch_trace
    assert res["kv_util_peak"] == sim.kv_util_peak
    assert res["kv_util_mean"] == sim.kv_util_mean
    assert res["peak_concurrency"] == sim.peak_concurrency
    assert res["prefix_hit_rate"] == sim.prefix_hit_rate
    assert res["cached_tokens_reused"] == sim.cached_tokens_reused
    assert res["cow_copies"] == sim.cow_copies
    assert res["prefix_evictions"] == sim.prefix_evictions


def assert_kv(tlayers, jstate, cfg):
    """Layer caches (ring rows, page pools, recurrent states) that each
    framework filled from float32 compute, leaf by leaf:

      * bf16 leaves (K/V, a conv tail in a bf16 cache): within two bf16
        ulps, fewer than 10 % of entries apart (ROADMAP Queue 3 entry 1:
        XLA and PyTorch sum the float32 projections in other orders, so a
        value at a rounding boundary can round the other way);
      * float32 leaves (the ``ssd`` and ``h`` states, every leaf of a
        float32 cache): within rtol = atol = 1e-4, the port's float32
        tolerance for the recurrent layers (summation order and scan
        order)."""
    jlayers = convert.stack_layers(jstate, cfg)
    assert len(tlayers) == len(jlayers) == cfg.num_layers
    for i, (tl, jl) in enumerate(zip(tlayers, jlayers)):
        for key, a in tl.items():
            b = np.asarray(jl[key])
            if a.dtype == torch.float32:
                assert b.dtype == np.float32, (i, key, b.dtype)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-4, err_msg=f"{i} {key}")
                continue
            assert a.dtype == torch.bfloat16, (i, key, a.dtype)
            diff = a.view(torch.int16).numpy() != b.view(np.int16)
            assert diff.mean() < 0.1, (i, key, int(diff.sum()))
            np.testing.assert_allclose(a.float().numpy(),
                                       b.astype(np.float32),
                                       rtol=2.0 ** -6, atol=1e-3)
