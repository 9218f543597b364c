"""PyTorch port: the serve loop's phases and the dispatches' device
intervals on the wall clock (``obs.Phases``), on the CPU.

  * the phases tile a tiny serve: each ``engine.iteration`` span's phases
    are its contiguous children, and the phases run without a gap from
    the serve's start to its result (the chunked loop and the stall loop
    with the prefix cache);
  * without a trace and without a profiler, a serve opens no profiler
    range and makes no CUDA event; under the profiler, with no trace,
    every range the benchmark's replay charges its idle gaps to
    (``rtbench/devtrace.py``'s ``HOST_CALLS``) is the program's own;
  * the device track: timing events mapped onto the wall clock through
    the anchor, and an executable's eager call marking its start
    (stand-in events; the graphs' own are tested in
    ``tests/test_torch_cuda.py``);
  * ``trace.idle_by_phase`` on a hand-made trace, the Perfetto export's
    process of its own for the wall tracks, the benchmark's three readers
    of the new spans on synthetic contexts, and the traced serve's parity
    view equal to the simulator's, which records no wall-clock span.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import datagen, personas  # noqa: E402
from repro_torch.core import priority as tprio  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

RTBENCH = Path(__file__).resolve().parent.parent / "rtbench"
CAPS = [2, 6, 1, 4, 6, 2, 3, 5, 1, 6, 2, 4]
ROWS = {
    "chunked": dict(prefill="chunked", chunk_size=3, token_budget=8),
    "stall-prefix": dict(prefill="stall", prefix_cache=True),
}
LOOP = {"host.enqueue", "host.admit", "host.plan", "dispatch.prefill",
        "host.collect", "host.first_tokens", "host.block_tables",
        "dispatch.decode_window", "host.window_bookkeeping",
        "host.snapshot", "dispatch.bulk_batch"}
SERVE = {"host.predict", "host.setup", "host.result"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(configs.get_smoke_config("starcoder2-3b"),
                              param_dtype="float32", compute_dtype="float32")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    corpus = datagen.generate_corpus(datagen.VARIANCE_MIXES["normal"], 64,
                                     seed=0)
    train, test = datagen.train_test_split(corpus, train_frac=0.5)
    persona = dataclasses.replace(personas.get_persona("bart"),
                                  batch_size=3)
    profile = tsched.offline_profile(train, persona, epochs=3, device="cpu")
    texts = [t.text for t in test[:len(CAPS)]]
    return dict(cfg=cfg, params=params, persona=persona, profile=profile,
                texts=texts)


def _policy(s, name="fifo", tau=1e18):
    pcfg = dataclasses.replace(s["profile"].policy_config(), tau=tau)
    return tsched.POLICIES[name](s["persona"], pcfg)


def _engine(s, row="chunked", obs=None, policy="fifo", tau=1e18):
    return tengine.ServingEngine(
        s["params"], s["cfg"], _policy(s, policy, tau), s["profile"],
        mode="continuous", kv="paged", kv_block_size=4, num_slots=3,
        input_bucket=8, max_new_tokens=6, decode_steps=2, eos_id=-1,
        obs=obs, device="cpu", **ROWS[row])


def _requests(s, spread: float = 0.0):
    return [tengine.Request(text=t, arrival=spread * i, task_id=i,
                            max_new_tokens=c)
            for i, (t, c) in enumerate(zip(s["texts"], CAPS))]


# ---------------------------------------------------------------------------
# the phases tile the serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", list(ROWS))
def test_phases_tile_each_iteration(setup, row):
    ob = tobs.Observability()
    res = _engine(setup, row, ob).serve(_requests(setup, spread=0.002))
    assert len(res["tasks"]) == len(CAPS)
    host = [sp for sp in ob.trace.spans if sp.track == "host"]
    iters = [sp for sp in host if sp.name == "engine.iteration"]
    phases = [sp for sp in host if sp.name != "engine.iteration"]
    names = {sp.name for sp in phases}
    assert names <= LOOP | SERVE
    assert SERVE | {"host.enqueue", "host.admit", "dispatch.prefill",
                    "host.first_tokens", "host.block_tables",
                    "dispatch.decode_window", "host.collect",
                    "host.window_bookkeeping", "host.snapshot"} <= names
    if row == "chunked":
        assert "host.plan" in names
    # from the serve's start to its result, one phase after another
    assert phases[0].name == "host.predict" and phases[0].ts == 0.0
    assert phases[1].name == "host.setup"
    assert phases[-1].name == "host.result"
    for a, b in zip(phases, phases[1:]):
        assert b.ts == pytest.approx(a.ts + a.dur, abs=1e-9), (a, b)
    # each iteration: its phases, contiguous, from its start to its end
    assert iters and iters[0].fields["step"] == 0
    assert [it.fields["step"] for it in iters] == sorted(
        it.fields["step"] for it in iters)
    inner = phases[2:-1]
    assert all(sp.name in LOOP for sp in inner)
    k = 0
    for it in iters:
        assert it.ts == pytest.approx(inner[k].ts, abs=1e-9)
        end = it.ts + it.dur
        while k < len(inner) and inner[k].ts < end - 1e-9:
            assert inner[k].ts + inner[k].dur <= end + 1e-9
            k += 1
        assert inner[k - 1].ts + inner[k - 1].dur == pytest.approx(
            end, abs=1e-9)
    assert k == len(inner)
    waits = {sp.fields["waits"] for sp in phases
             if sp.name == "host.collect"}
    assert waits == ({"prefill", "decode_window"} if row == "chunked"
                     else {"decode_window"})
    # no device track without a card
    assert not [sp for sp in ob.trace.spans if sp.track == "device"]


# ---------------------------------------------------------------------------
# off: no range, no event; under the profiler: the benchmark's ranges
# ---------------------------------------------------------------------------


def test_untraced_serve_opens_no_range_and_no_event(setup, monkeypatch):
    made = {"ranges": 0, "events": 0}
    real = torch.profiler.record_function

    class Range(real):
        def __init__(self, *a, **kw):
            made["ranges"] += 1
            super().__init__(*a, **kw)

    class Event:
        def __init__(self, *a, **kw):
            made["events"] += 1

    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    for row in ROWS:
        res = _engine(setup, row, policy="rt-lm", tau=0.0).serve(
            _requests(setup))
        assert len(res["tasks"]) == len(CAPS)
    assert made == {"ranges": 0, "events": 0}
    # a trace on the CPU records the phases, and still no range or event
    ob = tobs.Observability()
    _engine(setup, "chunked", ob).serve(_requests(setup))
    assert any(sp.track == "host" for sp in ob.trace.spans)
    assert made == {"ranges": 0, "events": 0}


def test_profiler_sees_every_range_the_replay_charges(setup):
    """``devtrace.HOST_CALLS`` names the ranges the benchmark's replay
    wraps around engine calls; the program opens each under the same name
    itself.  RT-LM with ``tau`` 0 offloads the queue's front while the
    queue is long, so the serve also runs the bulk lane."""
    from torch.profiler import ProfilerActivity, profile
    devtrace = _load(RTBENCH / "devtrace.py", "rtbench_devtrace_phases")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _engine(setup, "chunked", policy="rt-lm", tau=0.0).serve(
            _requests(setup))
    assert {t.task.lane for t in res["tasks"]} == {"gpu", "cpu"}
    ranges = {e.name for e in prof.events()}
    labels = {label for _, _, label in devtrace.HOST_CALLS}
    assert labels <= ranges, labels - ranges
    assert LOOP | SERVE | {"engine.iteration"} <= ranges
    assert not any(n.startswith("dispatch:") for n in ranges)


# ---------------------------------------------------------------------------
# the device track, with stand-in events
# ---------------------------------------------------------------------------


class _Device:
    """A stand-in ``torch.cuda.Event``: ``record`` stamps the device
    clock's current time (ms), ``elapsed_time`` subtracts."""

    now_ms = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        self.t = _Device.now_ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_intervals_map_through_the_anchor():
    """An interval runs from the first start collected since the last
    one (an eager call's event here, before a graph's own) to the
    readback's event; without a start nothing is recorded."""
    assert tobs.Phases(None, events=_Device).starts is None
    off = tobs.Phases(tobs.Observability(trace=False), events=_Device)
    assert off.event() is None and off.starts is None
    ob = tobs.Observability()
    ph = tobs.Phases(ob, events=_Device)
    assert tobs.Phases(ob).origin == ph.origin       # one axis a bundle
    _Device.now_ms = 1000.0
    ph.anchor()
    wall = ph._anchor[1] - ph.origin
    _Device.now_ms = 1030.0
    ph.start()
    _Device.now_ms = 1035.0
    ph.starts.append(ph.event())
    _Device.now_ms = 1050.0
    end = ph.event()
    ph.device("device.prefill", end, tokens=3)
    assert ph.starts == []
    ph.device("device.decode_window", end)           # no start collected
    ph.start()
    ph.device("device.bulk_batch", None)             # no end event
    (sp,) = ob.trace.spans
    assert (sp.name, sp.track, sp.fields) == ("device.prefill", "device",
                                             {"tokens": 3})
    assert sp.ts == pytest.approx(wall + 0.030, abs=1e-12)
    assert sp.dur == pytest.approx(0.020, abs=1e-12)
    assert ob.overhead_s > 0.0


def test_an_eager_call_marks_its_start(monkeypatch):
    """With ``starts`` handed over, an executable's eager call appends a
    timing event recorded before it runs (a replay appends its graph's
    own, on the card only); without, it makes none."""
    import numpy as np
    from repro_torch.serving import generate as tgen
    monkeypatch.setattr(torch.cuda, "Event", _Device)
    _Device.now_ms = 7.0
    ex = tgen.GraphExecutable(lambda x: x + 1, "window", "cpu")
    out = ex.call_aot("k", np.zeros(2, np.int32))
    assert out.tolist() == [1, 1] and ex.starts is None
    ex.starts = []
    ex.call_aot("k", np.zeros(2, np.int32))
    (ev,) = ex.starts
    assert isinstance(ev, _Device) and ev.t == 7.0


# ---------------------------------------------------------------------------
# idle_by_phase and the Perfetto export
# ---------------------------------------------------------------------------


def _hand_trace() -> tobs.TraceRecorder:
    rec = tobs.TraceRecorder()
    for name, a, b in [("engine.iteration", 0.0, 10.0),
                       ("host.enqueue", 0.0, 1.0), ("host.admit", 1.0, 3.0),
                       ("dispatch.prefill", 3.0, 4.0),
                       ("host.collect", 4.0, 6.0),
                       ("host.first_tokens", 6.0, 7.0),
                       ("dispatch.decode_window", 7.0, 8.0),
                       ("host.collect", 8.0, 10.0),
                       ("host.result", 11.5, 12.0)]:
        rec.span(name, a, b - a, "host")
    for a, b in [(3.5, 5.5), (7.5, 9.5), (9.0, 9.75)]:
        rec.span("device.x", a, b - a, "device")
    rec.span("decode.window", 0.0, 50.0)          # the engine clock's
    return rec


def test_idle_by_phase_charges_each_gap_to_its_innermost_phase():
    """Gaps [0, 3.5], [5.5, 7.5] and [9.75, 12]; the device's two
    overlapping intervals count once.  By midpoint, each gap whole to
    ``host.admit``, ``host.first_tokens`` and, for a midpoint in no phase
    (``engine.iteration`` is not one), ``host.other``; within each phase,
    the gaps split at the phases' edges, and [10, 11.5] in no phase."""
    got = tobs.idle_by_phase(_hand_trace())
    assert got == {"window_s": 12.0, "busy_s": 4.25,
                   "idle_s": {"host.admit": 3.5, "host.other": 2.25,
                              "host.first_tokens": 2.0},
                   "within_s": {"host.admit": 2.0, "host.enqueue": 1.0,
                                "host.first_tokens": 1.0,
                                "host.collect": 0.75,
                                "dispatch.prefill": 0.5,
                                "dispatch.decode_window": 0.5,
                                "host.result": 0.5}}
    for split in ("idle_s", "within_s"):
        v = list(got[split].values())
        assert v == sorted(v, reverse=True)
    assert tobs.idle_by_phase(tobs.TraceRecorder()) == {
        "window_s": 0.0, "busy_s": 0.0, "idle_s": {}, "within_s": {}}


def test_perfetto_puts_the_wall_tracks_in_a_process_of_their_own():
    doc = _hand_trace().to_perfetto()["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in doc
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {1: "requests", 2: "engine", 3: "wall clock"}
    threads = {e["tid"]: e["args"]["name"] for e in doc
               if e["ph"] == "M" and e["name"] == "thread_name"
               and e["pid"] == 3}
    assert threads == {1: "host", 2: "device"}
    where = {(e["name"], e["pid"], e["tid"]) for e in doc if e["ph"] == "X"}
    assert ("decode.window", 2, 0) in where
    assert ("host.admit", 3, 1) in where and ("device.x", 3, 2) in where
    assert not {n for n, pid, _ in where if pid == 2} - {"decode.window"}
    engine_only = tobs.TraceRecorder()
    engine_only.span("decode.window", 0.0, 1.0)
    assert 3 not in {e["pid"] for e in engine_only.to_perfetto()[
        "traceEvents"]}


# ---------------------------------------------------------------------------
# the benchmark's readers of the new spans
# ---------------------------------------------------------------------------

SPANS = [("prefill.ragged", 1.0), ("decode.window", 2.0),
         ("bulk_batch", 4.0), ("host.predict", 0.5), ("host.admit", 0.25),
         ("device.prefill", 0.5), ("device.decode_window", 1.5),
         ("device.bulk_batch", 0.5)]


@pytest.mark.parametrize("name,want", [
    ("device.idle_share.window", 100.0 * (1.0 - 2.5 / 8.0)),
    # charged: 1 + 2 + 4 / cpu_slowdown 4
    ("engine.dispatch_device_share.rt", 100.0 * 2.5 / 4.0),
    ("sched.predict_share", 100.0 * 0.5 / 8.0)])
def test_readers_of_the_wall_spans(name, want):
    read = _load(RTBENCH / "metrics" / f"{name}.py",
                 "rtbench_metric_phases_" + name.replace(".", "_")).read
    ctx = {"spans": SPANS, "wall_s": 8.0, "cpu_slowdown": 4.0}
    assert read(ctx) == pytest.approx(want, rel=1e-12)
    kind = "host.predict" if name == "sched.predict_share" else "device."
    bare = [(n, d) for n, d in SPANS if not n.startswith(kind)]
    assert read(dict(ctx, spans=bare)) is None
    assert read(dict(ctx, spans=[])) is None


# ---------------------------------------------------------------------------
# the parity view
# ---------------------------------------------------------------------------


def test_parity_view_is_the_simulators(setup):
    """The wall-clock spans stay out of ``parity_events()``: a traced
    chunked serve's is the simulator's, which records none."""
    ob = tobs.Observability()
    eng = _engine(setup, "chunked", ob)
    res = eng.serve(_requests(setup))
    tasks = []
    for i, (t, c) in enumerate(zip(setup["texts"], CAPS)):
        n = float(len(t.split()))
        tasks.append(tprio.SimTask(
            task=tengine.Request(text=t, arrival=0.0, task_id=i),
            u=float(max(setup["profile"].predictor.score(t), 0.0)), r=0.0,
            d=tprio.priority_point(0.0, n, setup["persona"].phi, None,
                                   xi=2.0),
            input_len=n, true_out_len=c))
    sob = tobs.Observability()
    sim = tsim.simulate_continuous(
        tasks, _policy(setup), num_slots=3, prefill="chunked", chunk_size=3,
        token_budget=8, decode_steps=2, prompt_len=8, kv_block_size=4,
        kv_num_blocks=eng.kv_num_blocks, obs=sob)
    assert res["completion_order"] == [t.task.task_id for t in sim.tasks]
    assert {sp.track for sp in ob.trace.spans} == {"engine", "host"}
    assert {sp.track for sp in sob.trace.spans} == {"engine"}
    assert ob.trace.parity_events() == sob.trace.parity_events()
