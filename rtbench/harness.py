"""One run of a cell: set-up, the measured window, the metrics, the check.

A cell is a ``workloads`` entry of ``BENCHMARK.json``; everything else is
found by name (nothing here names a configuration, a mix or a metric):

  * ``configs/<config>.json``: the published keys, the sizes as run
    (``model``), the reference's name (``references/<reference>.py``),
    the knee of each engine row and the limit of the check;
  * ``traffic/<traffic>.json``: the mix's parameters, read by the
    generator ``traffic/<kind>.py``, the engine row it is served on and
    the load as a share of the knee;
  * ``engines/<engine>.json``: the ``ServingEngine`` row;
  * ``metrics/<metric>.py``: one reader a metric, ``read(ctx)``.

The window is one ``ServingEngine.serve()`` call on the cell's whole
arrival schedule, from just before the call to the ``synchronize()``
after it.  The program gets the generated requests and the weights and
nothing else.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# engine-clock seconds of the schedule the traced run's profiled serve
# covers: a whole 30 s window of starcoder2-3b runs ~6.6 million kernels,
# whose record the profiler and its reader take minutes over
TRACE_SECONDS = 10.0
# the engine path's two kernels, by the names of their device functions
KERNEL_TAGS = ("paged_decode_split_kernel", "paged_decode_combine_kernel",
               "ragged_prefill_kernel")


def load_module(path: Path, name: str):
    """The module at ``path``, loaded once under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    engine: dict
    rate: Optional[float]            # requests per engine-clock second
    end_to_end: List[dict]           # the cell's metrics of each kind
    per_layer: List[dict]


def _applies(metric: dict, workload: str, e2e_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def load_cell(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = _json(ROOT / cfg_entry["file"])
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    engine = _json(HERE / "engines" / f"{traffic['engine']}.json")
    knee = config.get("knee_per_s", {}).get(traffic["engine"])
    rate = None if knee is None else knee * traffic["load_of_knee"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(workload, entry["chips"], config, traffic, engine, rate,
                e2e, per)


def model_config(model: dict, name: str):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name=name, **model)


def forbidden(module: str) -> bool:
    """Whether ``module``'s top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return module.split(".")[0] in FORBIDDEN


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if forbidden(m))


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Setup:
    cell: Cell
    model: dict                # the sizes as run
    cfg: object                # the port's ModelConfig of them
    weights: dict
    generator: object          # traffic/<kind>.py
    persona: object
    profile: object            # m_theta and its thresholds
    device: object


def setup(cell: Cell, seed: int, device, *,
          model: Optional[dict] = None) -> Setup:
    """Weights made from the seed on ``device`` and m_theta trained on the
    mix's training half.  ``model`` replaces the configuration's sizes
    (the CPU tests' small shapes)."""
    import weights as weights_lib
    from repro_torch.core import scheduler as sched
    model = model or cell.config["model"]
    cfg = model_config(model, cell.config["name"])
    weights = weights_lib.make(model, seed, device,
                               cell.config.get("init"))
    gen = load_module(HERE / "traffic" / f"{cell.traffic['kind']}.py",
                      f"rtbench_traffic_{cell.traffic['kind']}")
    first = gen.make(cell.traffic, rate=1.0, seconds=1.0, seed=seed,
                     num_slots=cell.engine["num_slots"])
    profile = sched.offline_profile(
        first.train, first.persona, epochs=cell.traffic["profile_epochs"],
        seed=cell.traffic["profile_seed"], device=device)
    return Setup(cell, model, cfg, weights, gen, first.persona, profile,
                 device)


def make_engine(su: Setup, obs=None):
    from repro_torch.core import scheduler as sched
    from repro_torch.serving.engine import ServingEngine
    row = su.cell.engine
    policy = sched.POLICIES[row["policy"]](su.persona,
                                           su.profile.policy_config())
    keys = ("mode", "kv", "prefill", "num_slots", "input_bucket",
            "chunk_size", "token_budget", "kv_block_size", "max_new_tokens",
            "decode_steps", "eos_id")
    return ServingEngine(su.weights, su.cfg, policy, su.profile,
                         obs=obs, device=su.device,
                         **{k: row[k] for k in keys})


def requests_for(su: Setup, rate: float, seconds: float, seed: int,
                 stream: int = 0):
    from repro_torch.serving.engine import Request
    tr = su.generator.make(su.cell.traffic, rate=rate, seconds=seconds,
                           seed=seed, num_slots=su.cell.engine["num_slots"],
                           stream=stream)
    return [Request(text=r["text"], arrival=r["arrival"], task_id=i,
                    max_new_tokens=r["max_new_tokens"])
            for i, r in enumerate(tr.requests)]


def warm_up(su: Setup, rate: float, seed: int) -> None:
    """One short serve of the cell's own traffic (its own stream of the
    seed): the kernels built or loaded, the libraries' handles and the
    allocator's pools made.  Its CUDA graphs belong to its own cache and
    do not carry over: the window's serve captures its own."""
    import torch
    reqs = requests_for(su, rate, su.cell.traffic["warmup_s"], seed,
                        stream=1)
    make_engine(su).serve(reqs)
    if su.device.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    started: float             # perf_counter at the window's start
    wall_s: float
    requests: List[dict]       # every request sent, as plain records
    result: dict               # the engine's result, less its task list
    graph_stats: dict
    spans: List[tuple]         # (name, engine-clock duration) with obs on
    trace: Optional[dict]      # devtrace.summarize, traced runs only
    memory_peak_bytes: int


def _record(req) -> dict:
    return {"text": req.text, "arrival": req.arrival,
            "max_new_tokens": req.max_new_tokens, "lane": req.lane,
            "out_tokens": list(req.out_tokens),
            "token_times": list(req.token_times), "finish": req.finish,
            "queue_wait_s": req.queue_wait_s}


def _serve(su: Setup, reqs, *, obs=None, profile: bool = False):
    """One serve of ``reqs`` on a fresh engine: (wall seconds, start,
    result, graph stats, the profiler's summary or None).  With
    ``profile``, under the profiler, the engine's calls into its layers
    wrapped in ranges.  Frees the engine (its caches and graphs)."""
    import torch
    import devtrace
    cuda = su.device.type == "cuda"
    eng = make_engine(su, obs=obs)
    if profile:
        devtrace.instrument(eng, torch)
    if cuda:
        torch.cuda.synchronize()
    with devtrace.traced(torch, profile) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            t0 = time.perf_counter()
            res = eng.serve(reqs)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    summary = (devtrace.summarize(prof, torch, KERNEL_TAGS)
               if prof is not None else None)
    result = {k: v for k, v in res.items() if k != "tasks"}
    stats = eng.graph_stats()
    del eng, res, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return wall, t0, result, stats, summary


def run_window(su: Setup, make_requests, trace: bool) -> Window:
    """Serve the schedule ``make_requests()`` once: the window.  With
    ``trace``, under an ``Observability`` bundle (its spans and counters);
    then, on the card, the schedule's first ``TRACE_SECONDS`` once more
    under the profiler for the device's record, because tracing every
    kernel slows the card's dispatches (by a fifth for starcoder2-3b's
    ~140 000 kernels a second) and would change the queues the first
    serve's counters read."""
    import torch
    from repro_torch.obs import Observability
    cuda = su.device.type == "cuda"
    reqs = make_requests()
    obs = Observability() if trace else None
    wall, t0, result, stats, _ = _serve(su, reqs, obs=obs)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    spans = ([(s.name, s.dur) for s in obs.trace.spans]
             if obs is not None else [])
    summary = None
    if trace and cuda:
        head = [r for r in make_requests() if r.arrival < TRACE_SECONDS]
        t1 = time.perf_counter()
        summary = _serve(su, head, profile=True)[4]
        if summary is not None:
            summary["requests"] = len(head)
            summary["work"] = work_of(su, [_record(r) for r in head])
            summary["seconds_taken"] = time.perf_counter() - t1
    return Window(t0, wall, [_record(r) for r in reqs], result, stats,
                  spans, summary, peak)


# ---------------------------------------------------------------------------
# metrics and the check
# ---------------------------------------------------------------------------


def work_of(su: Setup, records: List[dict]) -> dict:
    """counting.request_work over the finished requests of ``records``,
    each prompt counted as tokenized, without the bucket's padding."""
    import check as check_lib
    import counting
    bucket = su.cell.engine["input_bucket"]
    V = su.model["vocab_size"]
    return counting.request_work(su.model, [
        (len(check_lib.hash_tokenize(r["text"], V, bucket)),
         len(r["out_tokens"]), r["lane"])
        for r in records if r["finish"] >= 0.0])


def context(su: Setup, win: Window, setup_s: float) -> dict:
    """What the metric readers read: ``work`` counts the window's
    requests, ``trace["work"]`` those of the profiled serve."""
    import counting
    done = [r for r in win.requests if r["finish"] >= 0.0]
    work = work_of(su, done)
    return {"setup_s": setup_s, "wall_s": win.wall_s,
            "requests": win.requests, "done": done, "result": win.result,
            "graph_stats": win.graph_stats, "spans": win.spans,
            "trace": win.trace, "work": work,
            "cpu_slowdown": su.persona.cpu_slowdown,
            "clock_end_s": max((r["finish"] for r in done), default=0.0),
            "peak_flops": counting.PEAK_FLOPS}


def read_metrics(metrics: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each metric's reader, ``metrics/<name>.py``; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "rtbench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_checks(su: Setup, win: Window, seed: int,
               quant: Optional[str] = None):
    """(the numbers compared, each with its limit, None where no limit is
    set yet; numbers read beside them)."""
    import check as check_lib
    V = su.model["vocab_size"]
    done = [r for r in win.requests if r["finish"] >= 0.0]
    wrong = sum(len(r["out_tokens"]) != r["max_new_tokens"] for r in done)
    bad = sum(any(t < 0 or t >= V for t in r["out_tokens"]) for r in done)
    checks = {"unfinished": {"value": len(win.requests) - len(done),
                             "limit": 0},
              "wrong_length": {"value": wrong, "limit": 0},
              "bad_token_ids": {"value": bad, "limit": 0}}
    info = {}
    if done:
        batch = check_lib.sample(done, seed, su.cell.traffic["check_tokens"])
        limits = su.cell.config["check"]
        t0 = time.perf_counter()
        g = check_lib.judge(su.weights, su.model, su.cell.config["reference"],
                            batch, su.cell.engine["input_bucket"], su.device,
                            quant=quant, drop_gap=limits.get("drop_gap"))
        checks["max_logit_gap"] = {"value": g.pop("max_logit_gap"),
                                   "limit": limits["max_logit_gap"]}
        if "nonpad_drop_share" in g:
            checks["nonpad_drop_share"] = {
                "value": g.pop("nonpad_drop_share"),
                "limit": limits.get("nonpad_drop_share")}
        info = dict(g, requests_judged=len(batch),
                    check_s=time.perf_counter() - t0)
    return checks, info


def passed(checks: Dict[str, dict]) -> bool:
    """Every number with a limit within it, and the gap compared at all."""
    if "max_logit_gap" not in checks:
        return False
    for c in checks.values():
        if c["limit"] is None:
            continue
        if not c["value"] <= c["limit"]:
            return False
    return checks["max_logit_gap"]["limit"] is not None


# ---------------------------------------------------------------------------
# a whole run
# ---------------------------------------------------------------------------


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, *, model: Optional[dict] = None, say=print) -> dict:
    """Set-up, warm-up, the window, the metrics and the check: the result
    line's object.  ``say`` takes the lines for standard error; the
    numbers compared come last."""
    import torch
    su = setup(cell, seed, device, model=model)
    warm_up(su, cell.rate, seed)
    win = run_window(su, lambda: requests_for(su, cell.rate, seconds, seed),
                     trace=trace)
    reqs = win.requests
    setup_s = win.started - t_start
    ctx = context(su, win, setup_s)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
    done = ctx["done"]
    offloaded = sum(r["lane"] == "cpu" for r in done)
    say(f"window {win.wall_s:.4f} s wall; schedule {reqs[-1]['arrival']:.4f} s "
        f"and clock {ctx['clock_end_s']:.4f} s of engine clock; requests "
        f"sent {len(reqs)}, completed {len(done)}, offloaded {offloaded}; "
        f"rate {cell.rate:.3f}/s; set-up {setup_s:.2f} s")
    ttft = [r["token_times"][0] - r["arrival"] for r in done
            if r["token_times"]]
    if ttft:
        # the p95 beside the bounded median: each serve captures its CUDA
        # graphs inside the window, and the requests queued behind that
        # capture make the tail swing from run to run
        say("time to first token, engine clock: " + json.dumps({
            "ttft_p50_s": float(np.median(ttft)),
            "ttft_p95_s": float(np.percentile(ttft, 95)),
            "ttft_p99_s": float(np.percentile(ttft, 99))}))
    res = win.result
    say("engine: " + json.dumps({
        k: res.get(k) for k in ("ttft_p50", "ttft_p99", "itl_p50", "itl_p99",
                                "mean_response_s", "queue_wait_p90",
                                "scheduler_overhead_s", "peak_concurrency",
                                "rejected_for_memory", "prefill_dispatches",
                                "decode_dispatches", "exec_cache_misses")}))
    say("graphs: " + json.dumps(win.graph_stats))
    if win.trace is not None:
        say("trace: " + json.dumps({k: win.trace[k] for k in (
            "window_s", "busy_s", "kernel_s", "device_events", "requests",
            "seconds_taken")}))
    checks, info = run_checks(su, win, seed)
    cuda = device.type == "cuda"
    out = {"correct": passed(checks), "attempted": len(reqs),
           "failed": len(reqs) - len(done) + checks["wrong_length"]["value"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": win.memory_peak_bytes}}
    if win.trace is not None:
        out["device"]["busy_s"] = win.trace["busy_s"]
        out["device"]["window_s"] = win.trace["window_s"]
        out["breakdown"] = {"device_ops": win.trace["device_ops"],
                            "idle_gaps": win.trace["idle_gaps"]}
    out["info"] = info
    out["checks"] = checks
    say("read beside the check: " + json.dumps(info))
    for name, c in checks.items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    return out
