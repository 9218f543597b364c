#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card — name and power limit (``nvidia-smi``), torch/CUDA versions,
     and the build of both CUDA kernels from ``src/repro_torch/csrc``;
  2. kernels — each kernel against its plain PyTorch version on the card
     at the serving path's shapes (starcoder2-3b: H=24, KV=2, D=128,
     block 16, bf16), scattered pages bit-equal; median times of the
     kernel, the plain version and a library yardstick (gather + SDPA,
     timed here only), each with the L2 cache flushed, beside the bound;
  3. model — full-width starcoder2-3b (seeded random bf16 weights, depth
     and widths as published): two fused ragged prefill iterations and a
     4-step paged decode window, once through the kernels and once
     through the plain path, logits compared;
  4. engine — ``ServingEngine(mode="continuous", kv="paged",
     prefill="chunked", decode_steps=4)`` under the RT-LM policy serves 32
     requests at full width; the kernels' launch counts are reset just
     before and read just after.  The same serve runs once more under
     ``torch.profiler`` for the device's busy time and the kernels' share.

Then one JSON line of kernel results, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Needs a CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0

# the serving path's shapes (starcoder2-3b, engine settings of phase 4)
H, KV, D = 24, 2, 128
BS = 16
NUM_SLOTS = 16
INPUT_BUCKET = 128
CHUNK = 32
MAX_NEW = 64
DECODE_STEPS = 4
N_REQUESTS = 32

# H100 SXM peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# bf16 output: one bf16 ulp at |x| ~ 1 is 2^-7 ~ 7.8e-3; the kernel and the
# plain version sum in float32 in different orders, so allow ~2.5 ulps
KERNEL_ATOL = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    with the 50 MB L2 cache flushed before every call (the serving loop
    finds each layer's pages cold: every other layer's weights and pages
    pass through L2 between two visits)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _pool(torch, gen, nb_total: int):
    shape = (nb_total, BS, KV, D)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v


def check_decode(torch, F, kmod) -> dict:
    """B = num_slots rows over a pool sized like the engine's, with mixed
    lengths including 0 and 1."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    B = NUM_SLOTS
    max_len = INPUT_BUCKET + MAX_NEW + 8
    nb = -(-max_len // BS)
    N = B * nb + 1
    lens = rng.integers(2, INPUT_BUCKET + MAX_NEW, size=B)
    lens[0], lens[1] = 0, 1
    tables = rng.permutation(N - 1)[:B * nb].reshape(B, nb)
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kp, vp = _pool(torch, gen, N)
    tab = torch.from_numpy(tables.astype(np.int32)).to("cuda")
    sl = torch.from_numpy(lens.astype(np.int32)).to("cuda")
    out = kmod.paged_flash_decode_attention(q, kp, vp, tab, sl)
    torch.cuda.synchronize()
    ref = kmod.paged_decode_attention_ref(q, kp, vp, tab, sl)
    err = float((out.float() - ref.float()).abs().max())
    if not torch.isfinite(out).all() or err > KERNEL_ATOL:
        fail(f"paged decode kernel vs plain: max abs err {err}")
    if out[0].abs().max() != 0:
        fail("paged decode kernel: a seq_len == 0 row is not zeros")

    idx = (tab.long()[:, :, None] * BS
           + torch.arange(BS, device="cuda")).reshape(B, nb * BS)
    mask = (torch.arange(nb * BS, device="cuda")[None, :]
            < sl.long()[:, None])[:, None, None, :]

    def library():
        k = kp.view(N * BS, KV, D)[idx].transpose(1, 2)
        v = vp.view(N * BS, KV, D)[idx].transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)

    live = int(lens.sum())
    bytes_moved = (2 * q.numel() * 2 + tab.numel() * 4 + sl.numel() * 4
                   + 2 * live * KV * D * 2)
    flops = 4 * live * H * D
    b_ms, b_by = bound(bytes_moved, flops)
    return {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: kmod.paged_flash_decode_attention(
            q, kp, vp, tab, sl)),
        "plain_ms": time_ms(torch, lambda: kmod.paged_decode_attention_ref(
            q, kp, vp, tab, sl)),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"B": B, "H": H, "KV": KV, "D": D, "bs": BS, "nb": nb,
                  "live_tokens": live},
    }


def check_ragged(torch, F, kmod) -> dict:
    """Three chunks with non-zero and zero context (T_pad = 32) and one
    chunk_len == 0 padding chunk with an all-trash table."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    T = CHUNK
    per_seq = INPUT_BUCKET // BS
    chunks = [(0, 32, 32), (1, 96, 32), (2, 0, 16)]    # (slot, ctx, len)
    C = len(chunks) + 1
    N = NUM_SLOTS * (-(-(INPUT_BUCKET + MAX_NEW + 8) // BS)) + 1
    trash = N - 1
    nb = -(-(INPUT_BUCKET + MAX_NEW + 8) // BS)
    blocks = rng.permutation(N - 1)[:len(chunks) * per_seq]
    tables = np.full((C, nb), trash, np.int32)
    meta = np.zeros((C, 4), np.int32)
    off = 0
    for c, (slot, ctx, ln) in enumerate(chunks):
        tables[c, :per_seq] = blocks[c * per_seq:(c + 1) * per_seq]
        meta[c] = (slot, ctx, ln, off)
        off += ln
    meta[-1] = (NUM_SLOTS, 0, 0, off)
    q = torch.randn((C, T, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kn = torch.randn((C, T, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    vn = torch.randn((C, T, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kp, vp = _pool(torch, gen, N)
    tab = torch.from_numpy(tables).to("cuda")
    mt = torch.from_numpy(meta).to("cuda")
    kp1, vp1 = kp.clone(), vp.clone()
    out = kmod.ragged_chunked_prefill(q, kn, vn, kp1, vp1, tab, mt)
    torch.cuda.synchronize()
    kp2, vp2 = kp.clone(), vp.clone()
    ref = kmod.ragged_chunked_prefill_ref(q, kn, vn, kp2, vp2, tab, mt)
    if not (torch.equal(kp1, kp2) and torch.equal(vp1, vp2)):
        fail("ragged prefill kernel: scattered pages differ from the plain "
             "version's")
    if not torch.equal(kp1[trash], kp[trash]):
        fail("ragged prefill kernel: the padding chunk wrote its pages")
    err = 0.0
    for c, (_, _, ln) in enumerate(chunks):
        err = max(err, float((out[c, :ln].float()
                              - ref[c, :ln].float()).abs().max()))
        if not torch.isfinite(out[c, :ln]).all():
            fail(f"ragged prefill kernel: non-finite output in chunk {c}")
    if err > KERNEL_ATOL:
        fail(f"ragged prefill kernel vs plain: max abs err {err}")

    # library yardstick: index_put scatter + gather + SDPA with the mask
    tl = torch.arange(T, device="cuda")
    ctx = mt[:, 1].long()
    lens = mt[:, 2].long()
    pos = ctx[:, None] + tl[None, :]
    flat = (torch.gather(tab.long(), 1, torch.clamp(pos // BS, max=nb - 1))
            * BS + pos % BS)
    rows = (tl[None, :] < lens[:, None]).reshape(-1).nonzero()[:, 0]
    dst = flat.reshape(-1)[rows]
    idx = (tab.long()[:, :, None] * BS
           + torch.arange(BS, device="cuda")).reshape(C, nb * BS)
    kv_pos = torch.arange(nb * BS, device="cuda")
    rel = kv_pos[None, None, :] - ctx[:, None, None]
    mask = ((kv_pos[None, None, :] < ctx[:, None, None])
            | ((rel >= 0) & (rel <= tl[None, :, None])
               & (rel < lens[:, None, None])))[:, None]
    qt = q.transpose(1, 2)

    def library():
        kp.view(N * BS, KV, D)[dst] = kn.reshape(C * T, KV, D)[rows]
        vp.view(N * BS, KV, D)[dst] = vn.reshape(C * T, KV, D)[rows]
        k = kp.view(N * BS, KV, D)[idx].transpose(1, 2)
        v = vp.view(N * BS, KV, D)[idx].transpose(1, 2)
        return F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                              enable_gqa=True)

    # only the real chunks' rows t < chunk_len count: their q rows read
    # and output rows written, their k_new/v_new rows read and written to
    # the pages, and their prefix tokens read; padding rows and the
    # padding chunk need no traffic
    ctx_tok = sum(cx for _, cx, _ in chunks)
    new_tok = sum(ln for _, _, ln in chunks)
    bytes_moved = (2 * new_tok * H * D * 2           # q in, out
                   + 2 * 2 * new_tok * KV * D * 2    # k_new/v_new in, pages
                   + 2 * ctx_tok * KV * D * 2        # prefix pages in
                   + tab.numel() * 4 + mt.numel() * 4)
    keys = sum(ln * cx + ln * (ln + 1) // 2 for _, cx, ln in chunks)
    flops = 4 * keys * H * D
    b_ms, b_by = bound(bytes_moved, flops)
    return {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: kmod.ragged_chunked_prefill(
            q, kn, vn, kp1, vp1, tab, mt)),
        "plain_ms": time_ms(torch, lambda: kmod.ragged_chunked_prefill_ref(
            q, kn, vn, kp2, vp2, tab, mt)),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"C": C, "T_pad": T, "H": H, "KV": KV, "D": D, "bs": BS,
                  "nb": nb, "chunks": chunks},
    }


# ---------------------------------------------------------------------------
# phase 3: full-width model, kernels against the plain path
# ---------------------------------------------------------------------------

# bf16 model over 30 layers: the two attention paths round differently
# (about one bf16 ulp per attention output), which the residual stream
# carries into the logits; logits of the random-weight model are O(1)
LOGIT_ATOL = 0.25


def check_model(torch, cfg, params) -> dict:
    """NUM_SLOTS sequences of 2 chunks each: two fused prefill iterations
    (context 0, then 32), then DECODE_STEPS decode steps in lockstep, both
    paths fed the kernel path's greedy token (so a bf16 near-tie cannot
    send the two caches down different sequences), then one free-running
    ``decode_steps_paged`` window on each path, whose top-1 agreement is
    reported.  Kernel path and plain path use separate caches from the
    same weights."""
    from repro_torch.kvcache.paged import PagedKVCache
    from repro_torch.models import model as model_lib
    from repro_torch.prefill import build_packed_arrays
    rng = np.random.default_rng(SEED + 2)
    C = NUM_SLOTS
    prompts = rng.integers(2, cfg.vocab_size, size=(C, 2 * CHUNK))
    # prompt, the lockstep steps, the window, and the profiler's warm
    # and measured windows
    max_len = 2 * CHUNK + 4 * DECODE_STEPS
    nb_seq = -(-max_len // BS)
    as_t = lambda a: torch.from_numpy(a).to("cuda")  # noqa: E731
    paths = (True, False)                    # use_kernels
    caches, prefill_logits = {}, {}
    for use_kernels in paths:
        kvc = PagedKVCache(cfg, C, C * nb_seq, BS, max_len, device="cuda")
        for s in range(C):
            kvc.set_table(s, list(range(s * nb_seq, (s + 1) * nb_seq)))
        for it in range(2):                  # ctx 0, then ctx 32
            entries = [(s, it * CHUNK,
                        prompts[s, it * CHUNK:(it + 1) * CHUNK],
                        kvc.tables[s]) for s in range(C)]
            toks, tc, meta, tabs = build_packed_arrays(
                (C * CHUNK, C, CHUNK), entries, pad_slot=C,
                table_width=kvc.max_blocks_per_seq,
                trash_block=kvc.trash_block)
            logits = model_lib.prefill_chunks(
                params, cfg, kvc.state, as_t(toks), as_t(tc), as_t(meta),
                as_t(tabs), chunk_pad=CHUNK, use_kernels=use_kernels)
        caches[use_kernels], prefill_logits[use_kernels] = kvc, logits
    lk, lp = prefill_logits[True], prefill_logits[False]
    prefill_err = float((lk - lp).abs().max())
    tok = torch.argmax(lk, dim=-1).to(torch.int32)[:, None]
    decode_err, agree = 0.0, []
    for _ in range(DECODE_STEPS):
        dk, dp = (model_lib.decode_step_paged(
            params, cfg, caches[u].state, tok, caches[u].tables_device(),
            use_kernels=u)[1] for u in paths)
        decode_err = max(decode_err, float((dk - dp).abs().max()))
        agree.append(float((dk.argmax(-1) == dp.argmax(-1)).float().mean()))
        if not torch.isfinite(dk).all():
            fail("model: non-finite decode logits")
        tok = torch.argmax(dk, dim=-1).to(torch.int32)[:, None]
    windows = [model_lib.decode_steps_paged(
        params, cfg, caches[u].state, tok, caches[u].tables_device(),
        num_steps=DECODE_STEPS, use_kernels=u) for u in paths]
    torch.cuda.synchronize()
    out = {
        "sequences": C,
        "prefill_logits_max_abs_err": prefill_err,
        "decode_logits_max_abs_err": decode_err,
        "logits_scale": float(lp.abs().max()),
        "prefill_top1_agree": float((lk.argmax(-1)
                                     == lp.argmax(-1)).float().mean()),
        "decode_top1_agree": min(agree),
        "window_top1_agree": float((windows[0] == windows[1])
                                   .float().mean()),
    }
    if not torch.isfinite(lk).all():
        fail("model: non-finite prefill logits")
    if max(prefill_err, decode_err) > LOGIT_ATOL:
        fail(f"model: kernel path vs plain path logits differ: {out}")
    kvk = caches[True]
    out["decode_window_profile"] = profile_window(
        torch, lambda: model_lib.decode_steps_paged(
            params, cfg, kvk.state, tok, kvk.tables_device(),
            num_steps=DECODE_STEPS, use_kernels=True))
    return out


def profile_window(torch, fn, warm: bool = True, cpu: bool = True) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the summed
    device time of its kernels (busy), the idle share, and the two port
    kernels' device time and share of the busy time.  "not measured" if
    the profiler reports no device time.  ``warm`` calls ``fn`` once
    before; ``cpu=False`` records device activity only (a whole serve
    launches millions of operations)."""
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()                                 # allocator, libraries
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # walk the raw device events: ``key_averages`` builds a Python object
    # per event, minutes for the millions of launches of a whole serve
    cuda = torch.autograd.DeviceType.CUDA
    busy, ours = 0.0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        t = e.duration_ns() * 1e-9
        busy += t
        for tag in ("paged_decode_kernel", "ragged_prefill_kernel"):
            if tag in e.name():
                ours[tag] = ours.get(tag, 0.0) + t
    if busy <= 0.0:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "kernel_device_s": ours,
            "kernel_share_of_busy": {k: v / busy for k, v in ours.items()}}


# ---------------------------------------------------------------------------
# phase 4: the engine at full width
# ---------------------------------------------------------------------------


def run_engine(torch, cfg, params, kmods) -> dict:
    from repro_torch.core import datagen, personas
    from repro_torch.core import scheduler as sched
    from repro_torch.serving.engine import Request, ServingEngine
    persona = dataclasses.replace(personas.get_persona("bart"),
                                  batch_size=NUM_SLOTS)
    corpus = datagen.generate_corpus(datagen.VARIANCE_MIXES["normal"], 512,
                                     seed=SEED)
    train, test = datagen.train_test_split(corpus, train_frac=0.5)
    t0 = time.perf_counter()
    profile = sched.offline_profile(train, persona, epochs=5, seed=SEED,
                                    device="cuda")
    profile_s = time.perf_counter() - t0
    tasks = test[:N_REQUESTS]

    def serve():
        policy = sched.POLICIES["rt-lm"](persona, profile.policy_config())
        eng = ServingEngine(
            params, cfg, policy, profile, mode="continuous", kv="paged",
            prefill="chunked", decode_steps=DECODE_STEPS,
            num_slots=NUM_SLOTS, kv_block_size=BS,
            input_bucket=INPUT_BUCKET, chunk_size=CHUNK,
            max_new_tokens=MAX_NEW, eos_id=-1, device="cuda")
        return eng.serve([Request(text=t.text, arrival=0.0, task_id=i,
                                  max_new_tokens=t.out_lens["bart"])
                          for i, t in enumerate(tasks)])

    for m in kmods:
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {m.NAME: m.launches for m in kmods}

    if len(res["tasks"]) != N_REQUESTS:
        fail(f"engine: {len(res['tasks'])} of {N_REQUESTS} requests done")
    for name, n in launches.items():
        if n <= 0:
            fail(f"engine: kernel {name} was never launched on the main "
                 "path")
    if any(x > 1 for x in res["prefill_dispatch_trace"]):
        fail("engine: more than one prefill launch in an iteration")
    if res["decode_steps_executed"] != DECODE_STEPS * res["decode_dispatches"]:
        fail("engine: decode steps != decode_steps x dispatches")
    gen_tokens = 0
    for t in res["tasks"]:
        r = t.task
        want = max(1, min(r.max_new_tokens, MAX_NEW))
        if r.out_len != want or len(r.out_tokens) != want:
            fail(f"engine: request {r.task_id} produced {r.out_len} tokens, "
                 f"expected {want} (eos disabled)")
        if not all(0 <= x < cfg.vocab_size for x in r.out_tokens):
            fail(f"engine: request {r.task_id} produced an id outside the "
                 "vocabulary")
        gen_tokens += r.out_len
    lanes = {"gpu": 0, "cpu": 0}
    for t in res["tasks"]:
        lanes[t.task.lane] += 1
    # the same serve again, on a fresh engine, under the profiler: the
    # device's busy time over the whole serve and the two kernels' share
    # of it (the timed serve above runs without the profiler's overhead)
    serve_profile = profile_window(torch, serve, warm=False, cpu=False)
    return {
        "launches": launches,
        "wall_s": wall,
        "profile_train_s": profile_s,
        "generated_tokens": gen_tokens,
        "generated_tokens_per_s": gen_tokens / wall,
        "ttft_p50_s": res["ttft_p50"], "ttft_p99_s": res["ttft_p99"],
        "itl_p50_s": res["itl_p50"], "itl_p99_s": res["itl_p99"],
        "lanes": lanes,
        "prefill_dispatches": res["prefill_dispatches"],
        "decode_dispatches": res["decode_dispatches"],
        "iterations": len(res["budget_trace"]),
        "rejected_for_memory": res["rejected_for_memory"],
        "peak_concurrency": res["peak_concurrency"],
        "serve_profile": serve_profile,
    }


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import KERNELS, _build
    from repro_torch.models import model as model_lib

    # -- phase 1: card and build
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    build_s = _build.build([m.NAME for m in KERNELS])
    print(f"kernel build: {json.dumps(build_s)} "
          f"(wall {time.perf_counter() - t0:.1f} s)", flush=True)

    # -- phase 2: kernels vs plain versions
    checks = {KERNELS[0].NAME: check_decode(torch, F, KERNELS[0]),
              KERNELS[1].NAME: check_ragged(torch, F, KERNELS[1])}
    for name, r in checks.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)

    # -- phase 3: full-width model
    cfg = configs.get_config("starcoder2-3b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model_lib.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    print(f"model: {cfg.name}, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params "
          f"({cfg.param_dtype}), init {time.perf_counter() - t0:.1f} s",
          flush=True)
    mres = check_model(torch, cfg, params)
    print(f"model check: {json.dumps(mres)}", flush=True)

    # -- phase 4: engine
    eres = run_engine(torch, cfg, params, KERNELS)
    print(f"engine [{card}]: {json.dumps(eres)}", flush=True)

    kernels = []
    for m in KERNELS:
        r = checks[m.NAME]
        kernels.append({
            "name": m.NAME, "route": "cuda", "source": m.SOURCE,
            "replaces": m.REPLACES, "launches": eres["launches"][m.NAME],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
