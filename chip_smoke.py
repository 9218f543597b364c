#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card — name and power limit (``nvidia-smi``), torch/CUDA versions,
     and the build of all seven CUDA kernel libraries from
     ``src/repro_torch/csrc``, one ``nvcc`` per source, all started
     together; the ``-Xptxas -v`` registers, spills and barriers of each
     (the attention kernels' shared memory is dynamic, sized at launch, so
     ptxas does not see it);
  2. kernels — each kernel against its plain PyTorch version on the card
     at full-width shapes (starcoder2-3b: H=24, KV=2, D=128, block 16,
     bf16; the windowed flash attention at h2o-danube-3-4b's H=32, KV=8,
     D=120), each output within ``kernels/compare.py``'s limit (scaled to
     |plain| and its mean) and scattered pages bit-equal; median times of
     the kernel, the plain version and a library yardstick (gather + SDPA,
     SDPA or ``F.rms_norm``, timed here only), each with the L2 cache
     flushed, beside the bound (for every kernel also the time with the
     host hidden, ``device_ms``, beside the library call's, the rate
     reached and the time over the bound; the two decode kernels' split
     plans and the grids).  The paged path's fused pointwise kernels at
     the rt cell's shapes (128 decode rows, 640 fused prefill rows), at
     starcoder2-3b's heads and d_model and at kimi-k2's (64/8 heads of
     112, d_model 7168): RoPE + K/V write (``rope_kv``, decode and packed)
     bit-equal to its plain chain, pages included, and the residual add +
     RMSNorm (``rms_norm.add_rms_norm``) with its sum bit-equal to torch's
     add and its norm within the limit, each timed against its plain
     chain beside the bound.  Then the kernel API (``kernels.ops``) as
     an entry point: every op once at those shapes, launch counts reset
     just before and read just after, outputs bit-equal to the kernels'
     own (``rope_kv`` has no op there);
  3. model — full-width starcoder2-3b (seeded random bf16 weights, depth
     and widths as published): two fused ragged prefill iterations and a
     4-step paged decode window, once through the kernels and once
     through the plain path, logits compared; then the single-chunk paged
     prefill (``generate.prefill_chunked`` -> ``model.prefill_chunk``) of
     one 128-token prompt in four 32-token chunks, through the kernel
     (launch counts reset just before, read just after), the plain path
     and the fused ``model.prefill_chunks``, final logits compared;
  4. engine — ``ServingEngine(mode="continuous", kv="paged",
     prefill="chunked", decode_steps=4)`` under the RT-LM policy serves 32
     requests at full width, eager (``generate.disable_graphs()``) and
     then graphed (the engine's CUDA graphs, the default), each on a fresh
     engine; the launch counts of the attention kernels, RMSNorm and
     ``rope_kv`` are reset just before each serve and read just after (a
     wrapper counts where it launches on the host, which a graph's replay
     does not run).  The same two serves run once more under
     ``torch.profiler`` for the device's busy time, its idle share and
     the kernels' share and number of runs, by name (the paged decode's
     split and combine kernels, the fused prefill, RMSNorm, RoPE + K/V).
     It fails unless the graphed serve gives the eager one's tokens and
     schedule, its profile ran each kernel as often as the eager one's and
     that as often as the eager wrappers launched it, every decode window
     replayed a graph, and the card idled a smaller share of the graphed
     serve;
  5. engine rows — the other valid rows of the configuration matrix at
     full width, each serving the same 16 requests whose 128-word prompts
     share their first 96 words (six 16-token blocks): ``mode="batch"``,
     continuous stall admission on the contiguous and on the paged cache,
     paged stall with ``prefix_cache=True``, and paged chunked with the
     prefix cache persistent across two serves; every row eager and then
     graphed.  Per serve: wall time, tokens/s, TTFT and ITL, iterations,
     the kernels' launches (counts reset just before, read just after),
     prefix hits and copies-on-write, the free blocks after, and for a
     graphed serve its graphs, replays, capture seconds and pool bytes
     (its growth of ``memory_reserved`` less the eager serve's); each
     one-serve row once more in each mode under ``torch.profiler`` (device
     busy time, idle share, kernels by name).  It fails unless every
     request is done with its cap, no block leaked, the prefix rows hit
     (the second persistent serve more than the first), every eager paged
     row launched the paged decode and the eager prefix rows the fused
     prefill, and every graphed serve equals its eager twin (tokens,
     schedule, hits, free blocks, and in a profiled row the kernels run,
     as in phase 4).  The share of requests with identical
     tokens across rows is printed, not held (the kernel path is held to
     its plain path by tolerance);
  6. observability — phase 4's workload, its requests in two traffic
     classes (``core.workload``: interactive with TTFT and ITL targets,
     batch with an end-to-end one), and then each phase-5 row, served
     graphed on a fresh engine with ``obs=Observability(...)`` (trace,
     metrics, SLO monitor, calibration ledger, health snapshots; the
     persistent row twice, each serve into its own bundle).  It fails
     unless each traced serve gives its untraced graphed twin's tokens,
     schedule, prefix hits and free blocks, emits only known non-fault
     event kinds, its counters equal the result's mirrors with no
     fallback, its JSONL (written to ``build/`` with the Perfetto JSON)
     reloads with the same events and rebuilds the result's TTFT / ITL
     p50 and p99, its calibration ledger and per-class SLO counts cover
     every request.  One ``engine obs`` line a serve: traced and untraced
     wall, the emitters' seconds, the event count, the serve thread's
     collect waits, the span sums, per-class attainment, calibration MAE
     and bias;
  7. replicas and faults — four engines on the card sharing the
     parameters (``serving.replica.ReplicatedEngine``).  7a: phase 4's row
     and requests (phase 6's two classes), traced, behind an ``rtlm``
     router with replica 3 the bulk slice, eager and then graphed, each on
     a fresh pool; it fails unless every request is done with its cap,
     every ``batch`` request and no ``interactive`` one is on replica 3,
     placements, route scores, per-replica streams and tokens are equal
     eager and graphed, each replica's tokens and schedule equal a fresh
     single engine's graphed serve of its group, no block is held, each
     replica's stream carries its label and no fault event appears.  7b:
     the paged stall row behind ``least_queue`` under a ``FaultPlan``
     (replica 3 crashes at its step 8 with its requests active, replica 2
     runs at half speed, a placement fails once, the doomed class times
     out, the bulk class is shed past four queued requests), eager and
     then graphed; it fails unless every request is completed, timed out,
     shed or dead-lettered exactly once, replica 3 crashed with survivors
     and every failover went elsewhere, every mechanism fired, no block is
     held, the ``faults.*`` counters equal the result, and the eager and
     graphed pools agree in placements, failovers, fault ids and counts,
     per-replica streams and tokens.  One ``engine pool`` line a serve:
     pool wall, tokens/s, TTFT / ITL p50 and p99, each replica's wall,
     rounds, graphs and capture seconds, the fault counts;
  8. the MoE and sliding-window families, each published config at full
     width, alone on the card (phases 1-7's weights and pools freed
     first), depth cut only where 80 GB forces it, every cut printed on
     the model line.  8a: kimi-k2-1t-a32b cut to its dense prefix layer
     and one MoE layer (384 experts top-8, a shared expert, D 112): the
     two engine kernels at its heads (H 64, KV 8, D 112) against their
     plain versions and timed as in phase 2, phase 3's model check, then
     phase 4's row serving 16 requests eager and graphed, and the graphed
     serve once more under the profiler; it fails unless every request
     is done with its cap, no block leaked, the graphed serve gives the
     eager one's tokens and schedule, and the profiled serve ran the
     paged decode's two kernels and the fused prefill's, by name, as
     often as the eager serve's wrappers launched them.  8b:
     h2o-danube-3-4b whole (window 4096) in batch mode and continuous
     stall on the contiguous ring; 8c: mixtral-8x22b cut to two layers
     (8 experts top-2, window 4096), continuous stall.  Both serve 8
     requests left-padded to a bucket of 4608, past the window, with caps
     of 32, eager and graphed, held as 8a; ``kv="paged"`` must raise the
     reference's refusal of a window.  One ``engine family`` line a
     serve: wall, tokens/s, TTFT / ITL p50 and p99, iterations, launches,
     capture seconds and the eager serve's prefill drop fractions;
  9. the recurrent families, each published config whole at full width,
     alone on the card (phase 8's models freed first).  9a: mamba2-1.3b
     (48 Mamba-2 layers, 64 SSD heads of 64, state 128, chunk 256): layer
     0's ``ssd_chunked`` on the inputs the layer gives it for two
     640-token prompts (three chunks, the last padded), in float32 against
     the step-by-step float32 recurrence (the reference's own check,
     within ``SSD_RTOL``) and in bf16 against the same call on the CPU
     (``kernels/compare.py``'s rule); a prefill of S = 640 tokens plus one
     decode step against a prefill of S + 1 (logits within phase 3's
     limit, top-1 equal); then batch mode and continuous stall (N = 4) on
     16 slots under RT-LM, 16 requests left-padded to 640 with caps of
     32.  9b: recurrentgemma-9b (38 layers: 12 x (rec, rec, attn_local)
     + (rec, rec); MQA heads of 256, local window 2048): the decode check
     at S = 2304, then both rows on 8 slots under FIFO, 8 requests
     left-padded to 2304, past the window, so the local attention runs
     its windowed prefill and the rings wrap.  Every serve eager and
     graphed, held as 8b; ``kv="paged"`` must raise the reference's
     family refusal.  One ``engine family`` line a serve, plus the
     ``ssd layer`` and ``decode check`` lines;
 10. the multimodal and encoder-decoder families, each published config
     whole at model level (their engine refuses them, as the reference's
     cannot serve them), alone on the card.  10a: llava-next-mistral-7b
     (32 layers, 2880 patch tokens); 10b: seamless-m4t-large-v2 (24
     encoder and 24 cross decoder layers, 4096 frames).  Each: 4 corpus
     prompts of 64 tokens behind seeded stub patches or frames; step 0's
     logits (the prefill's) against a float32 copy of the weights, within
     LOGIT_ATOL and the same top-1; ``generate.generate`` of 32 tokens
     (every row its 32, inside the vocabulary); the decode check of
     phase 9; four eager decode steps under ``torch.profiler`` (device
     busy, idle share, kernels, the costliest).  One ``multimodal`` line
     a model;
 11. training and the launchers.  11a: ``launch.train.main`` trains
     starcoder2-3b whole (``--no-smoke``: every layer rematerialised),
     AdamW lr 3e-4, B 4, S 1024, 20 steps, writing a checkpoint under
     ``build/``; the launcher's own first step (bf16) holds its loss
     within FIRST_LOSS_ATOL and its global gradient norm within
     FIRST_NORM_RTOL of a float32 copy of its weights on its first batch,
     which a planted fault (the copy with one layer skipped) must miss;
     after it, the restored checkpoint's leaves and eval loss equal the
     trained ones bit for bit.
     11b: mamba2-1.3b whole with Adafactor, B 4, S 1024, 10 steps.  Both:
     every loss and gradient norm finite, the mean of the last five
     losses below the first; seconds a step and peak ``memory_allocated``
     printed.  11c: ``launch.serve.main`` on the card at its smoke size
     with 16 requests, every request accounted for;
 12. the sharding layer (``repro_torch.sharding``): one NCCL rank a
     visible card, spawned, on the mesh (1, world) ("data", "model"),
     world and mesh printed.  12a: ``launch.train.main --mesh 1x<world>
     --no-smoke`` on starcoder2-3b at 11a's batch (AdamW, 3 steps), its
     first step held to 11a's float32 copy under 11a's limits, seconds a
     step and peak ``memory_allocated``; 12b: mixtral-8x22b's MoE layer
     alone at full width (4.8 GB bf16) through ``apply_moe_ep`` under
     the serving and the train layouts, each output held to
     ``apply_moe_local`` by ``kernels/compare.py``'s rule; 12c:
     full-width starcoder2-3b ``prefill`` + 4 ``decode_step``s under the
     serving layout, logits within LOGIT_ATOL of the unsharded run's with
     the same top-1.  A failed rank fails the script.  These paths run no
     CUDA kernel of the port (the reference's sharded steps reach no
     Pallas kernel either);
 13. the dry run and the simulator.  13a: the dry run's shape-only step
     (``launch.dryrun.dry_step``: fake tensors, ``op_cost`` and
     ``MemTracker``) of 11a's step (starcoder2-3b whole, B 4, S 1024,
     AdamW, remat) on a (1, 1) mesh of a fake world of one, then the same
     step for real on the card inside ``op_cost``: flops and HBM bytes of
     the two within 1 %, predicted resident bytes over the real step's
     peak ``memory_allocated`` within 0.8-1.25, the roofline's
     ``bound_s`` beside the measured seconds a step.  13b: ``python -m
     repro_torch.launch.dryrun --arch mamba2-1.3b --shape decode_32k`` in
     a subprocess on the host, mesh (16, 16) of a fake world of 256: it
     must end ``ok`` with flops and resident bytes above 0; its roofline
     and fit lines are printed; then starcoder2-3b x train_4k the same
     way, which must also count an all-to-all.  13c: the port's ``simulate_continuous``
     on phase 4's tasks (the engine's own ``u``, its settings): every
     field of SCHEDULE_FIELDS equal to phase 4's eager serve.  Then the
     phase's seconds and the whole run's.

Every number of phases 4 to 13, tokens and traces included, also goes to
``build/chip_smoke.json``.  Then one JSON line of kernel results
(each kernel's launches from the path that runs it: decode, ragged
prefill, RMSNorm and RoPE + K/V from phase 4's eager serve, beside them
``launches_d112`` from phase 8a's and ``device_ms_d112`` from phase 8a
or phase 2's kimi-k2 cases, chunked prefill from phase 3's
single-chunk path, the other two from phase 2's ops path), the
card line, and as the last line ``{"ok": true, "device": {...}}``.  Needs
a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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

# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet), for
# elementwise work such as RMSNorm; the bf16 and HBM peaks are
# ``repro_torch.launch.analysis``'s PEAK_FLOPS and HBM_BW
FP32_FLOPS_PER_S = 67e12

# the ops-path shapes beyond the serving path's
DECODE_S = 2048                  # contiguous flash decode: B=16 rows
FA_S = 2048                      # flash attention, starcoder2-3b heads
DANUBE = dict(H=32, KV=8, D=120, S=6144, window=4096)   # h2o-danube-3-4b
RMS_D = 3072                     # starcoder2-3b d_model

# the paged path's pointwise kernels at the rt cell's shapes (rtbench
# chat128: 128 decode slots, a 640-token fused prefill budget) and at
# kimi-k2's d_model; the RoPE table over ROPE_LEN positions
RT_SLOTS = 128
RT_PACKED = 640
KIMI_D = 7168
ROPE_LEN = 2048


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


# cycles of ``torch.cuda._sleep`` queued ahead of a call timed with
# ``hide_host``: ~0.5 ms at the H100's clocks, longer than the host takes to
# enqueue any call timed here
HOST_COVER_CYCLES = 1_000_000


def _time_call(torch, fn, flush, hide_host: bool) -> float:
    flush.zero_()
    if hide_host:
        torch.cuda._sleep(HOST_COVER_CYCLES)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def time_ms(torch, fn, reps: int = 20, warmup: int = 3,
            hide_host: bool = False) -> float:
    """Median device time of ``fn`` in ms, CUDA events around each call,
    with the 50 MB L2 cache flushed before every call (the serving loop
    finds each layer's pages cold: every other layer's weights and pages
    pass through L2 between two visits).  The card is idle when the first
    event fires, so the time includes what the host spends between it and
    the launch (for a call of ~0.05 ms, most of it).  ``hide_host`` queues
    a spin on the card before the first event, so the host has enqueued
    the call before the card reaches it: the card's own time."""
    return time_in_turns(torch, {"fn": fn}, reps, warmup, hide_host)["fn"]


def time_in_turns(torch, fns: dict, reps: int = 20, warmup: int = 3,
                  hide_host: bool = False) -> dict:
    """``time_ms`` of each of ``fns`` (name -> callable), taken in turns:
    each rep times every one, in order on even reps and in reverse on odd
    ones, so a drift of the host or the card during the measurement falls
    on all of them alike (a kernel and its yardstick are compared inside
    one call, in turns)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    times = {name: [] for name in fns}
    order = list(fns)
    for i in range(reps):
        for name in (order if i % 2 == 0 else order[::-1]):
            times[name].append(_time_call(torch, fns[name], flush,
                                          hide_host))
    return {name: statistics.median(t) for name, t in times.items()}


def bound(bytes_moved: float, flops: float, flops_per_s=None):
    """(ms, what bounds it) at the H100's HBM rate and ``flops_per_s``
    (default: its bf16 tensor-core peak)."""
    from repro_torch.launch import analysis
    t_bytes = bytes_moved / analysis.HBM_BW * 1e3
    t_ops = flops / (flops_per_s or analysis.PEAK_FLOPS) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def achieved(ms: float, bytes_moved: float, flops: float,
             bound_ms: float) -> dict:
    """The rates a kernel time reaches on the work the bound counts, and
    its time over the bound."""
    return {"tflop_per_s": flops / ms * 1e-9, "gb_per_s": bytes_moved / ms
            * 1e-6, "ms_over_bound": ms / bound_ms}


def ptxas_report(names) -> dict:
    """Registers, spills and barriers per kernel of each library named,
    from the ``-Xptxas -v`` log ``_build`` keeps beside it."""
    from repro_torch.kernels import _build
    out = {}
    for name in names:
        log = _build.library_path(name).with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        out[name] = [ln.split("info    :")[-1].strip() for ln in lines
                     if "Compiling entry" in ln or "Used" in ln
                     or "spill" in ln]
    return out


def prefill_grid(kmod, rows: int, KV: int, C: int) -> list:
    """The grid a prefill kernel launches for ``rows`` t-major query rows,
    from the CTA size its library exports (``rtlm_prefill_cta_rows``).
    Fails if the plain tile model (``ref.PREFILL_CTA_ROWS``) has another."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import PREFILL_CTA_ROWS
    cta = _build.load(kmod.NAME).rtlm_prefill_cta_rows()
    if cta != PREFILL_CTA_ROWS:
        fail(f"{kmod.NAME}: the kernel's CTA holds {cta} query rows, the "
             f"plain tile model {PREFILL_CTA_ROWS}")
    return [-(-rows // cta), KV, C]


def held(what: str, out, ref, shares: dict) -> float:
    """Max abs error of a kernel's output against its plain version.
    Fails unless every element is within ``compare.RTOL * (|plain| +
    mean |plain|)`` (``repro_torch.kernels.compare``: four times the worst
    one-ulp bf16 rounding gap); records the largest share of that limit
    an element used under ``shares[what]``."""
    from repro_torch.kernels.compare import compare
    err, share = compare(out, ref)
    shares[what] = share
    if not share <= 1.0:
        fail(f"{what}: kernel vs plain max abs err {err}, {share:.3g} x "
             "the limit")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _pool(torch, gen, nb_total: int, KV: int = KV, D: int = D):
    shape = (nb_total, BS, KV, D)
    k = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return k, v


def check_decode(torch, F, kmod, heads=(H, KV, D)) -> dict:
    """B = num_slots rows over a pool sized like the engine's, with mixed
    lengths including 0 and 1; ``heads``: (H, KV, D), starcoder2-3b's
    unless another model's are given."""
    H, KV, D = heads
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
    kp, vp = _pool(torch, gen, N, KV, D)
    tab = torch.from_numpy(tables.astype(np.int32)).to("cuda")
    sl = torch.from_numpy(lens.astype(np.int32)).to("cuda")
    out = kmod.paged_flash_decode_attention(q, kp, vp, tab, sl)
    torch.cuda.synchronize()
    shares = {}
    err = held("paged decode", out,
               kmod.paged_decode_attention_ref(q, kp, vp, tab, sl), shares)
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

    ops_call = ("paged_decode_attention",
                lambda ops: ops.paged_decode_attention(q, kp, vp, tab, sl),
                out)
    live = int(lens.sum())
    bytes_moved = (2 * q.numel() * 2 + tab.numel() * 4 + sl.numel() * 4
                   + 2 * live * KV * D * 2)
    flops = 4 * live * H * D
    b_ms, b_by = bound(bytes_moved, flops)
    run = lambda: kmod.paged_flash_decode_attention(  # noqa: E731
        q, kp, vp, tab, sl)
    host = time_in_turns(torch, {"kernel": run, "library": library})
    dev = time_in_turns(torch, {"kernel": run, "library": library},
                        hide_host=True)
    ms, device_ms = host["kernel"], dev["kernel"]
    from repro_torch.kernels import flash_decode_attention as fd
    n_splits, per = fd.split_plan(B, H, KV, nb * BS, fd._sm_count(q.device))
    grid = [KV * -(-(H // KV) // fd.ROW_BLOCK), B, n_splits]
    print(f"paged decode split plan: {n_splits} splits of {per} tile(s) "
          f"of {fd.TILE} positions over nb * bs = {nb * BS}, grid {grid} "
          f"({grid[0] * grid[1] * grid[2]} CTAs) + {B * H} combine CTAs",
          flush=True)
    return {
        "max_abs_err": err, "limit_share": shares, "ms": ms,
        "plain_ms": time_ms(torch, lambda: kmod.paged_decode_attention_ref(
            q, kp, vp, tab, sl)),
        "library_ms": host["library"],
        "bound_ms": b_ms, "bound_by": b_by,
        "achieved": achieved(ms, bytes_moved, flops, b_ms),
        "device_ms": device_ms,
        "library_device_ms": dev["library"],
        "device_achieved": achieved(device_ms, bytes_moved, flops, b_ms),
        "shape": {"B": B, "H": H, "KV": KV, "D": D, "bs": BS, "nb": nb,
                  "live_tokens": live, "n_splits": n_splits,
                  "tiles_per_split": per, "grid": grid},
        "ops": [ops_call],
    }


def check_ragged(torch, F, kmod, heads=(H, KV, D)) -> dict:
    """Three chunks with non-zero and zero context (T_pad = 32) and one
    chunk_len == 0 padding chunk with an all-trash table; ``heads`` as
    ``check_decode``."""
    H, KV, D = heads
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
    kp, vp = _pool(torch, gen, N, KV, D)
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
    err, shares = 0.0, {}
    for c, (_, _, ln) in enumerate(chunks):
        err = max(err, held(f"ragged prefill chunk {c}", out[c, :ln],
                            ref[c, :ln], shares))

    ops_call = ("ragged_chunked_prefill",
                lambda ops: ops.ragged_chunked_prefill(
                    q, kn, vn, kp.clone(), vp.clone(), tab, mt)[0], out)

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
    run = lambda: kmod.ragged_chunked_prefill(  # noqa: E731
        q, kn, vn, kp1, vp1, tab, mt)
    host = time_in_turns(torch, {"kernel": run, "library": library})
    dev = time_in_turns(torch, {"kernel": run, "library": library},
                        hide_host=True)
    ms, device_ms = host["kernel"], dev["kernel"]
    return {
        "max_abs_err": err, "limit_share": shares, "ms": ms,
        "plain_ms": time_ms(torch, lambda: kmod.ragged_chunked_prefill_ref(
            q, kn, vn, kp2, vp2, tab, mt)),
        "library_ms": host["library"],
        "bound_ms": b_ms, "bound_by": b_by,
        "achieved": achieved(ms, bytes_moved, flops, b_ms),
        "device_ms": device_ms,
        "library_device_ms": dev["library"],
        "device_achieved": achieved(device_ms, bytes_moved, flops, b_ms),
        "shape": {"C": C, "T_pad": T, "H": H, "KV": KV, "D": D, "bs": BS,
                  "nb": nb, "chunks": chunks,
                  "grid": prefill_grid(kmod, T * (H // KV), KV, C)},
        "ops": [ops_call],
    }


def check_chunked_prefill(torch, F, kmod) -> dict:
    """The single-chunk path's four launches of a 128-token prompt (B = 1,
    T = 32 at contexts 0, 32, 64, 96) and the four contexts in one B = 4
    launch; tables of the engine's width (13 entries), so entries past
    ctx + T are padding.  ``ms``, ``plain_ms``, ``library_ms`` and
    ``bound_ms`` (and the device times) are means over the four B = 1
    launches; each launch is timed in turns with gather + SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    T, ctxs = CHUNK, (0, 32, 64, 96)
    B = len(ctxs)
    nb = -(-(INPUT_BUCKET + MAX_NEW + 8) // BS)
    N = B * nb + 1
    tables = rng.permutation(N - 1)[:B * nb].reshape(B, nb)
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kp, vp = _pool(torch, gen, N)
    tab = torch.from_numpy(tables.astype(np.int32)).to("cuda")
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    kernel = lambda b: kmod.chunked_prefill_attention(  # noqa: E731
        q[b], kp, vp, tab[b], ctx[b])
    plain = lambda b: kmod.chunked_prefill_attention_ref(  # noqa: E731
        q[b], kp, vp, tab[b], ctx[b])
    kv_pos = torch.arange(nb * BS, device="cuda")
    tl = torch.arange(T, device="cuda")

    def library(b):
        idx = (tab[b].long()[:, :, None] * BS
               + torch.arange(BS, device="cuda")).reshape(-1, nb * BS)
        mask = (kv_pos[None, None, :]
                <= ctx[b].long()[:, None, None] + tl[None, :, None])
        k = kp.view(N * BS, KV, D)[idx].transpose(1, 2)
        v = vp.view(N * BS, KV, D)[idx].transpose(1, 2)
        return F.scaled_dot_product_attention(
            q[b].transpose(1, 2), k, v, attn_mask=mask[:, None],
            enable_gqa=True)

    def timed(b, cs):
        """Kernel and gather + SDPA in turns, with and without the host
        hidden, beside the plain version and the bound, for the rows
        ``b`` at contexts ``cs``."""
        bytes_moved = (2 * len(cs) * T * H * D * 2
                       + sum(2 * (c + T) * KV * D * 2 for c in cs)
                       + len(cs) * (nb + 1) * 4)
        flops = 4 * H * D * sum(c * T + T * (T + 1) // 2 for c in cs)
        b_ms, b_by = bound(bytes_moved, flops)
        fns = {"kernel": lambda: kernel(b), "library": lambda: library(b)}
        host = time_in_turns(torch, fns)
        dev = time_in_turns(torch, fns, hide_host=True)
        return {"ms": host["kernel"],
                "plain_ms": time_ms(torch, lambda: plain(b)),
                "library_ms": host["library"],
                "bound_ms": b_ms, "bound_by": b_by,
                "device_ms": dev["kernel"],
                "library_device_ms": dev["library"],
                "device_achieved": achieved(dev["kernel"], bytes_moved,
                                            flops, b_ms)}

    err, rows, shares = 0.0, [], {}
    for i in range(B):
        b = slice(i, i + 1)
        out = kernel(b)
        torch.cuda.synchronize()
        err = max(err, held(f"chunked prefill ctx {ctxs[i]}", out,
                            plain(b), shares))
        rows.append({"ctx": ctxs[i], **timed(b, ctxs[i:i + 1])})
    allb = slice(0, B)
    out4 = kernel(allb)
    torch.cuda.synchronize()
    err = max(err, held("chunked prefill B=4", out4, plain(allb), shares))
    mean = lambda k: sum(r[k] for r in rows) / len(rows)  # noqa: E731
    return {
        "max_abs_err": err, "limit_share": shares,
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "library_ms": mean("library_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": rows[-1]["bound_by"],
        "device_ms": mean("device_ms"),
        "library_device_ms": mean("library_device_ms"),
        "device_achieved": {k: sum(r["device_achieved"][k] for r in rows)
                            / len(rows) for k in rows[0]["device_achieved"]},
        "per_context": rows, "b4": timed(allb, ctxs),
        "shape": {"T": T, "H": H, "KV": KV, "D": D, "bs": BS, "nb": nb,
                  "contexts": list(ctxs),
                  "grid": prefill_grid(kmod, T * (H // KV), KV, 1)},
        "ops": [("chunked_prefill_attention",
                 lambda ops: ops.chunked_prefill_attention(q, kp, vp, tab,
                                                           ctx), out4)],
    }


def check_flash_decode(torch, F, kmod) -> dict:
    """B = 16 rows over a contiguous S = 2048 cache with per-row masks:
    valid lengths spread from 1 to 2048, and the longest row with a hole
    in the middle (a ring-style mask).  A separate all-masked row must
    return zeros."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    B, S = NUM_SLOTS, DECODE_S
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    kc = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    vc = torch.randn((B, S, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    lens = np.linspace(1, S, B).astype(np.int64)
    mask_np = np.arange(S)[None, :] < lens[:, None]
    mask_np[-1, S // 3:S // 2] = False
    mask = torch.from_numpy(mask_np).to("cuda")
    out = kmod.flash_decode_attention(q, kc, vc, mask)
    torch.cuda.synchronize()
    shares = {}
    err = held("flash decode", out,
               kmod.decode_attention_ref(q, kc, vc, mask), shares)
    empty = torch.zeros((1, S), dtype=torch.bool, device="cuda")
    zero = kmod.flash_decode_attention(q[:1].contiguous(), kc[:1], vc[:1],
                                       empty)
    torch.cuda.synchronize()
    if zero.abs().max() != 0:
        fail("flash decode kernel: an all-masked row is not zeros")

    m4 = mask[:, None, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                              attn_mask=m4, enable_gqa=True)

    valid = int(mask_np.sum())
    bytes_moved = (2 * q.numel() * 2 + B * S + 2 * valid * KV * D * 2)
    b_ms, b_by = bound(bytes_moved, 4 * valid * H * D)
    run = lambda: kmod.flash_decode_attention(q, kc, vc, mask)  # noqa: E731
    ms = time_ms(torch, run)
    device_ms = time_ms(torch, run, hide_host=True)
    n_splits, per = kmod.split_plan(B, H, KV, S, kmod._sm_count(q.device))
    return {
        "max_abs_err": err, "limit_share": shares, "ms": ms,
        "plain_ms": time_ms(torch, lambda: kmod.decode_attention_ref(
            q, kc, vc, mask)),
        "library_ms": time_ms(torch, library),
        "bound_ms": b_ms, "bound_by": b_by,
        "achieved": achieved(ms, bytes_moved, 4 * valid * H * D, b_ms),
        "device_ms": device_ms,
        "library_device_ms": time_ms(torch, library, hide_host=True),
        "device_achieved": achieved(device_ms, bytes_moved,
                                    4 * valid * H * D, b_ms),
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D,
                  "valid_slots": valid, "n_splits": n_splits,
                  "tiles_per_split": per,
                  "grid": [KV * -(-(H // KV) // kmod.ROW_BLOCK), B,
                           n_splits]},
        "ops": [("flash_decode_attention",
                 lambda ops: ops.flash_decode_attention(q, kc, vc, mask),
                 out)],
    }


def check_flash_attention(torch, F, kmod) -> dict:
    """Two prefill cases: starcoder2-3b heads, B = 1, S = 2048, causal;
    h2o-danube-3-4b widths, S = 6144, causal with window 4096.  The
    top-level numbers are the first case's; ``windowed`` holds the
    second's."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = [dict(H=H, KV=KV, D=D, S=FA_S, window=None), DANUBE]
    res, calls, shares = [], [], {}
    for c in cases:
        S, Hc, KVc, Dc, W = c["S"], c["H"], c["KV"], c["D"], c["window"]
        q = torch.randn((1, S, Hc, Dc), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((1, S, KVc, Dc), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((1, S, KVc, Dc), generator=gen, device="cuda").to(
            torch.bfloat16)
        run = lambda: kmod.flash_attention(  # noqa: E731
            q, k, v, causal=True, window=W)
        out = run()
        torch.cuda.synchronize()
        err = held(f"flash attention S={S} window={W}", out,
                   kmod.attention_ref(q, k, v, causal=True, window=W),
                   shares)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if W is None:
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            pairs = S * (S + 1) // 2
        else:
            i = torch.arange(S, device="cuda")
            wmask = ((i[None, :] <= i[:, None])
                     & (i[:, None] - i[None, :] < W))
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=wmask, enable_gqa=True)
            pairs = sum(min(j + 1, W) for j in range(S))
        bytes_moved = 2 * S * Hc * Dc * 2 + 2 * S * KVc * Dc * 2
        flops = 4 * pairs * Hc * Dc
        b_ms, b_by = bound(bytes_moved, flops)
        ms = time_ms(torch, run)
        device_ms = time_ms(torch, run, hide_host=True)
        res.append({
            "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(torch, lambda: kmod.attention_ref(
                q, k, v, causal=True, window=W), reps=5),
            "library_ms": time_ms(torch, library),
            "bound_ms": b_ms, "bound_by": b_by,
            "achieved": achieved(ms, bytes_moved, flops, b_ms),
            "device_ms": device_ms,
            "library_device_ms": time_ms(torch, library, hide_host=True),
            "device_achieved": achieved(device_ms, bytes_moved, flops,
                                        b_ms),
            "shape": {"B": 1, "S": S, "H": Hc, "KV": KVc, "D": Dc,
                      "causal": True, "window": W}})
        calls.append((f"flash_attention S={S}",
                      lambda ops, q=q, k=k, v=v, W=W: ops.flash_attention(
                          q, k, v, causal=True, window=W), out))
    top = dict(res[0])
    top["max_abs_err"] = max(r["max_abs_err"] for r in res)
    top["limit_share"] = shares
    top["windowed"] = res[1]
    top["ops"] = calls
    return top


def check_rms_norm(torch, F, kmod) -> dict:
    """x (2048, 3072) and (16, 3072) bf16 (a prefill's and a decode
    step's rows at starcoder2-3b's d_model), eps 1e-6, and (8192, 3072),
    whose extra bytes over the 2048-row case give the kernel's streaming
    rate apart from the fixed cost of a call.  The top-level numbers are
    the 2048-row case's; ``decode_rows`` and ``rows_8192`` hold the
    others."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    w = (torch.randn((RMS_D,), generator=gen, device="cuda") * 0.1).to(
        torch.bfloat16)
    w1 = 1.0 + w
    res, calls, shares = [], [], {}
    for n in (2048, NUM_SLOTS, 8192):
        x = torch.randn((n, RMS_D), generator=gen, device="cuda").to(
            torch.bfloat16)
        out = kmod.rms_norm(x, w, 1e-6)
        torch.cuda.synchronize()
        err = held(f"rms_norm {n} rows", out,
                   kmod.rms_norm_ref(x, w, 1e-6), shares)
        bytes_moved = 2 * x.numel() * 2 + w.numel() * 2
        b_ms, b_by = bound(bytes_moved, 4 * x.numel(), FP32_FLOPS_PER_S)
        run = lambda x=x: kmod.rms_norm(x, w, 1e-6)  # noqa: E731
        library = lambda x=x: F.rms_norm(  # noqa: E731
            x, (RMS_D,), weight=w1, eps=1e-6)
        host = time_in_turns(torch, {"kernel": run, "library": library})
        dev = time_in_turns(torch, {"kernel": run, "library": library},
                            hide_host=True)
        ms, device_ms = host["kernel"], dev["kernel"]
        res.append({
            "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(torch, lambda: kmod.rms_norm_ref(x, w,
                                                                 1e-6)),
            "library_ms": host["library"],
            "bound_ms": b_ms, "bound_by": b_by,
            "achieved": achieved(ms, bytes_moved, 4 * x.numel(), b_ms),
            "device_ms": device_ms,
            "library_device_ms": dev["library"],
            "device_achieved": achieved(device_ms, bytes_moved,
                                        4 * x.numel(), b_ms),
            "shape": {"rows": n, "D": RMS_D, "dtype": "bfloat16"}})
        calls.append((f"rms_norm {n} rows",
                      lambda ops, x=x: ops.rms_norm(x, w, eps=1e-6), out))
    top = dict(res[0])
    top["max_abs_err"] = max(r["max_abs_err"] for r in res)
    top["limit_share"] = shares
    top["decode_rows"] = res[1]
    top["rows_8192"] = res[2]
    top["add"] = check_add_rms_norm(torch, kmod, gen)
    top["ops"] = calls
    return top


def time_against_plain(torch, run, plain) -> dict:
    """A kernel and its plain chain timed in turns, each with the host
    showing (``ms``, ``plain_ms``) and hidden (``device_ms``,
    ``plain_device_ms``)."""
    fns = {"kernel": run, "plain": plain}
    host = time_in_turns(torch, fns)
    dev = time_in_turns(torch, fns, hide_host=True)
    return {"ms": host["kernel"], "device_ms": dev["kernel"],
            "plain_ms": host["plain"], "plain_device_ms": dev["plain"]}


def check_add_rms_norm(torch, kmod, gen) -> dict:
    """``add_rms_norm`` (the attention residual add and ``ln2``) at the
    rt cell's decode rows and fused prefill rows, at starcoder2-3b's and
    kimi-k2's d_model: the sum bit-equal to torch's bf16 add, the norm
    held against ``rms_norm_ref`` of that sum; times against the plain
    add + norm, beside the byte bound.  Keyed ``"<rows>x<D>"``."""
    out, shares = {}, {}
    for D_ in (RMS_D, KIMI_D):
        w = (torch.randn((D_,), generator=gen, device="cuda") * 0.1).to(
            torch.bfloat16)
        for n in (RT_SLOTS, RT_PACKED):
            x, y = (torch.randn((n, D_), generator=gen, device="cuda").to(
                torch.bfloat16) for _ in range(2))
            s_, o = kmod.add_rms_norm(x, y, w, 1e-6)
            torch.cuda.synchronize()
            key = f"{n}x{D_}"
            if not torch.equal(s_, x + y):
                fail(f"add_rms_norm {key}: the sum differs from x + y")
            err = held(f"add_rms_norm {key}", o,
                       kmod.rms_norm_ref(x + y, w, 1e-6), shares)
            bytes_moved = 4 * x.numel() * 2 + w.numel() * 2
            b_ms, b_by = bound(bytes_moved, 5 * x.numel(), FP32_FLOPS_PER_S)

            def plain(x=x, y=y, w=w):
                s2 = x + y
                return s2, kmod.rms_norm_ref(s2, w, 1e-6)
            out[key] = {"max_abs_err": err, "limit_share": shares[
                f"add_rms_norm {key}"], "bound_ms": b_ms, "bound_by": b_by,
                **time_against_plain(
                    torch, lambda x=x, y=y, w=w: kmod.add_rms_norm(
                        x, y, w, 1e-6), plain)}
    return out


def check_rope_kv(torch, F, kmod) -> dict:
    """RoPE + K/V page write at the rt cell's shapes, for starcoder2-3b's
    heads (24/2 of 128: the top level) and kimi-k2's (64/8 of 112:
    ``d112``): ``rope_kv_decode`` over RT_SLOTS decode rows (positions
    include a block's last row and a fresh block's first) and
    ``rope_kv_packed`` (``packed``) over RT_PACKED packed rows gathered
    into 8-row-overlapping padded views clipped at the end, as the
    engine's ``qidx`` gathers them.  Each must equal its plain chain bit
    for bit (``ref.rope_kv_decode_ref``: the rotated q and both page
    pools; ``ref.rope_kv_packed_ref``: q, k and v).  Times against the
    plain chain, beside the byte bound; no library call does this."""
    from repro_torch import configs
    from repro_torch.models import layers
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    res = {}
    for label, name in (("d128", "starcoder2-3b"),
                        ("d112", "kimi-k2-1t-a32b")):
        cfg = configs.get_config(name)
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        theta = cfg.rope_theta
        table = layers.rope_table(d, theta, ROPE_LEN, "cuda")
        B, nb = RT_SLOTS, ROPE_LEN // BS
        q, k, v = rnd(B, 1, h, d), rnd(B, 1, kv, d), rnd(B, 1, kv, d)
        pos = torch.randint(0, ROPE_LEN, (B,), generator=gen,
                            device="cuda", dtype=torch.int32)
        pos[:4] = torch.tensor([BS - 1, BS, 0, ROPE_LEN - 1],
                               dtype=torch.int32)
        tables = torch.randperm(B * nb, generator=gen, device="cuda").view(
            B, nb).to(torch.int32)
        pools = [torch.zeros((B * nb, BS, kv, d), dtype=bf, device="cuda")
                 for _ in range(4)]

        def dec(p=pools):
            return kmod.rope_kv_decode(q, k, v, pos, tables, p[0], p[1],
                                       theta=theta, table=table)

        def dec_plain(p=pools):
            return kmod.rope_kv_decode_ref(q, k, v, pos, tables, p[2],
                                           p[3], theta)
        got, want = dec(), dec_plain()
        torch.cuda.synchronize()
        for what, a, b in (("q", got, want), ("k pages", pools[0], pools[2]),
                           ("v pages", pools[1], pools[3])):
            if not torch.equal(a, b):
                fail(f"rope_kv_decode at {name}'s heads: {what} differ "
                     "from the plain chain")
        heads = h + 2 * kv
        b_ms, b_by = bound(2 * B * heads * d * 2 + B * d * 4,
                           3 * d * (h + kv) * B, FP32_FLOPS_PER_S)
        decode = {"max_abs_err": 0.0, "bit_equal": True, "bound_ms": b_ms,
                  "bound_by": b_by,
                  **time_against_plain(torch, dec, dec_plain),
                  "shape": {"rows": B, "H": h, "KV": kv, "D": d,
                            "table_rows": ROPE_LEN}}
        del pools

        T, C, Tp = RT_PACKED, RT_PACKED // CHUNK, CHUNK + 8
        ctx = torch.randint(0, ROPE_LEN - CHUNK, (C,), generator=gen,
                            device="cuda", dtype=torch.int32)
        positions = (ctx[:, None] + torch.arange(
            CHUNK, device="cuda", dtype=torch.int32)[None]).reshape(-1)
        rows = torch.clamp(torch.arange(C, device="cuda")[:, None] * CHUNK
                           + torch.arange(Tp, device="cuda")[None], 0,
                           T - 1).reshape(-1)
        pq, pk, pv = rnd(T, h, d), rnd(T, kv, d), rnd(T, kv, d)

        def pack():
            return kmod.rope_kv_packed(pq, pk, pv, positions, rows,
                                       theta=theta, table=table)

        def pack_plain():
            return kmod.rope_kv_packed_ref(pq, pk, pv, positions, rows,
                                           theta)
        for what, a, b in zip("qkv", pack(), pack_plain()):
            if not torch.equal(a, b):
                fail(f"rope_kv_packed at {name}'s heads: {what} differs "
                     "from the plain chain")
        R = rows.shape[0]
        b_ms, b_by = bound(2 * R * heads * d * 2 + R * (d * 4 + 12),
                           3 * d * (h + kv) * R, FP32_FLOPS_PER_S)
        packed = {"max_abs_err": 0.0, "bit_equal": True, "bound_ms": b_ms,
                  "bound_by": b_by,
                  **time_against_plain(torch, pack, pack_plain),
                  "shape": {"packed_rows": T, "view_rows": R, "H": h,
                            "KV": kv, "D": d}}
        res[label] = dict(decode, packed=packed)
    top = dict(res["d128"], library_ms=None, d112=res["d112"], ops=[])
    return top


def run_ops_path(torch, kmods, calls) -> dict:
    """The kernel API as an entry point: each op once at the phase-2
    shapes through ``kernels.ops`` (``use_kernels=None``), with every
    launch count reset just before and read just after.  Each output must
    equal the kernel's own phase-2 output bit for bit (the kernels are
    deterministic) and every kernel must have launched."""
    from repro_torch.kernels import ops
    for m in kmods:
        m.launches = 0
    outs = [fn(ops) for _, fn, _ in calls]
    torch.cuda.synchronize()
    launches = {m.NAME: m.launches for m in kmods}
    for (what, _, want), got in zip(calls, outs):
        if not torch.equal(got, want):
            fail(f"ops path: {what} differs from the kernel's phase-2 "
                 "output")
    for name, n in launches.items():
        if n <= 0:
            fail(f"ops path: kernel {name} was never launched")
    return launches


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


def check_single_chunk(torch, cfg, params, kmods) -> dict:
    """The single-chunk paged prefill at full width and depth: one
    128-token prompt in four 32-token chunks through
    ``generate.prefill_chunked`` (-> ``model.prefill_chunk``) with the
    kernel, its launch counts reset just before and read just after, then
    through the plain path and through the fused ``model.prefill_chunks``
    (kernel, one chunk per iteration).  Final logits within LOGIT_ATOL of
    each other and the same top-1 token."""
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    from repro_torch.prefill import build_packed_arrays
    from repro_torch.serving import generate
    rng = np.random.default_rng(SEED + 7)
    S = INPUT_BUCKET
    nb = S // BS
    prompt_np = rng.integers(2, cfg.vocab_size, size=S).astype(np.int32)
    row_np = rng.permutation(nb).astype(np.int32)
    prompt = torch.from_numpy(prompt_np[None]).to("cuda")
    row = torch.from_numpy(row_np).to("cuda")
    cache = lambda: transformer.init_paged_cache(  # noqa: E731
        cfg, 1, nb + 1, BS, device="cuda")

    for m in kmods:
        m.launches = 0
    torch.cuda.synchronize()
    ck = cache()
    lk = generate.prefill_chunked(params, cfg, ck, prompt, 0, row,
                                  chunk_size=CHUNK, use_kernels=True)
    torch.cuda.synchronize()
    launches = {m.NAME: m.launches for m in kmods}
    want = (S // CHUNK) * cfg.num_layers
    if launches["chunked_prefill_attention"] != want:
        fail(f"single-chunk path: {launches['chunked_prefill_attention']} "
             f"chunked-prefill launches, expected {want}")
    lp = generate.prefill_chunked(params, cfg, cache(), prompt, 0, row,
                                  chunk_size=CHUNK, use_kernels=False)
    cf = cache()
    for lo in range(0, S, CHUNK):
        arrays = build_packed_arrays(
            (CHUNK, 1, CHUNK), [(0, lo, prompt_np[lo:lo + CHUNK], row_np)],
            pad_slot=1, table_width=nb, trash_block=nb)
        lf = model_lib.prefill_chunks(
            params, cfg, cf, *(torch.from_numpy(a).to("cuda")
                               for a in arrays),
            chunk_pad=CHUNK, use_kernels=True)[0]
    torch.cuda.synchronize()
    out = {
        "launches": launches,
        "chunks": S // CHUNK,
        "logits_max_abs_err_vs_plain": float((lk - lp).abs().max()),
        "logits_max_abs_err_vs_fused": float((lk - lf).abs().max()),
        "logits_scale": float(lp.abs().max()),
        "top1": [int(x.argmax()) for x in (lk, lp, lf)],
        "pos": int(ck["pos"][0]),
    }
    if not torch.isfinite(lk).all():
        fail("single-chunk path: non-finite logits")
    if max(out["logits_max_abs_err_vs_plain"],
           out["logits_max_abs_err_vs_fused"]) > LOGIT_ATOL:
        fail(f"single-chunk path: logits differ: {out}")
    if len(set(out["top1"])) != 1:
        fail(f"single-chunk path: top-1 tokens differ: {out}")
    if out["pos"] != S:
        fail(f"single-chunk path: pos {out['pos']}, expected {S}")
    return out


#: seconds the profiled window stays open after the last kernel
PROFILE_TAIL_S = 0.25

# the device kernels of the engine path's port kernels
# (csrc/paged_decode_attention.cu, csrc/ragged_chunked_prefill.cu, and
# the fused pointwise csrc/rms_norm.cu and csrc/rope_kv.cu)
PROFILE_TAGS = ("paged_decode_split_kernel", "paged_decode_combine_kernel",
                "ragged_prefill_kernel", "rms_norm_kernel",
                "rope_kv_")          # both rope_kv kernels


def profile_window(torch, fn, warm: bool = True, cpu: bool = True,
                   top: int = 0) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the summed
    device time of its kernels (busy), the idle share, and the engine
    path's port kernels' device time and share of the busy time (the
    paged decode as its split and combine kernels and their sum
    ``paged_decode``, the fused prefill) and how many times each ran
    (``kernel_events``; the profiler names kernels inside CUDA graphs
    too).  "not measured" if
    the profiler reports no device time.  ``warm`` calls ``fn`` once
    before; ``cpu=False`` records device activity only (a whole serve
    launches millions of operations).  ``top`` > 0 adds the number of
    device kernels and the ``top`` kernels by summed device time (name cut
    to 96 characters, seconds, count)."""
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
        # the trace keeps only device records its clock places inside the
        # window, and the device clock drifts from the host's over a long
        # process: close the window well after the last kernel
        time.sleep(PROFILE_TAIL_S)
    # walk the raw device events: ``key_averages`` builds a Python object
    # per event, minutes for the millions of launches of a whole serve
    cuda = torch.autograd.DeviceType.CUDA
    busy, ours, events = 0.0, {}, dict.fromkeys(PROFILE_TAGS, 0)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        t = e.duration_ns() * 1e-9
        busy += t
        if top:
            row = by_name.setdefault(e.name()[:96], [0.0, 0])
            row[0] += t
            row[1] += 1
        for tag in PROFILE_TAGS:
            if tag in e.name():
                ours[tag] = ours.get(tag, 0.0) + t
                events[tag] += 1
    ours["paged_decode"] = sum(ours.get(tag, 0.0) for tag in PROFILE_TAGS
                               if tag.startswith("paged_decode"))
    if busy <= 0.0:
        return {"wall_s": wall, "device_busy_s": "not measured"}
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_idle_share": max(0.0, 1.0 - busy / wall),
           "kernel_device_s": ours, "kernel_events": events,
           "kernel_share_of_busy": {k: v / busy for k, v in ours.items()}}
    if top:
        out["device_kernels"] = sum(n for _, n in by_name.values())
        out["top_kernels"] = sorted(([k, t, n] for k, (t, n)
                                     in by_name.items()),
                                    key=lambda r: -r[1])[:top]
    return out


# ---------------------------------------------------------------------------
# phase 4: the engine at full width
# ---------------------------------------------------------------------------


def serving_inputs() -> dict:
    """The persona, the m_theta trained on the card (5 epochs) and the
    test corpus that phases 4 and 5 serve."""
    from repro_torch.core import datagen, personas
    from repro_torch.core import scheduler as sched
    persona = dataclasses.replace(personas.get_persona("bart"),
                                  batch_size=NUM_SLOTS)
    corpus = datagen.generate_corpus(datagen.VARIANCE_MIXES["normal"], 512,
                                     seed=SEED)
    train, test = datagen.train_test_split(corpus, train_frac=0.5)
    t0 = time.perf_counter()
    profile = sched.offline_profile(train, persona, epochs=5, seed=SEED,
                                    device="cuda")
    return {"persona": persona, "profile": profile, "test": test,
            "profile_s": time.perf_counter() - t0}


#: what must not change between an eager and a graphed serve of one engine
#: row: the schedule (all requests arrive at t = 0, so the measured step
#: times that advance the engine clock cannot reorder it)
SCHEDULE_FIELDS = ("completion_order", "budget_trace", "prefill_dispatches",
                   "prefill_dispatch_trace", "decode_dispatches",
                   "decode_dispatch_trace", "exec_cache_hits",
                   "exec_cache_misses", "rejected_for_memory", "cow_copies",
                   "cached_tokens_reused")


def timed_serve(torch, eng, requests, kmods, graphed: bool):
    """One serve of ``eng``, eager (under ``generate.disable_graphs()``) or
    graphed (the default), its kernels' launch counts reset just before
    and read just after.  A wrapper counts where it launches on the host:
    in a graphed serve that is its eager calls and captures, not its
    replays (which ``kernel_events`` of a profiled serve count).  Garbage
    left by earlier phases (a profile's event objects) is collected first,
    and the interpreter's cyclic collections during the serve are timed.
    Returns (result, wall s, launches, the growth of ``memory_reserved``
    over the serve, {"gc_before_s", "gc_pauses", "gc_pause_s"})."""
    import contextlib
    import gc
    from repro_torch.serving.generate import disable_graphs
    host = {"gc_pauses": 0, "gc_pause_s": 0.0}
    started = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            host["gc_pauses"] += 1
            host["gc_pause_s"] += time.perf_counter() - started.pop()

    t0 = time.perf_counter()
    gc.collect()
    host["gc_before_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    for m in kmods:
        m.launches = 0
    gc.callbacks.append(on_gc)
    try:
        with contextlib.nullcontext() if graphed else disable_graphs():
            t0 = time.perf_counter()
            res = eng.serve(requests)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    return (res, wall, {m.NAME: m.launches for m in kmods},
            torch.cuda.memory_reserved() - reserved, host)


def profiled_serve(torch, make_engine, requests, graphed: bool) -> dict:
    """A fresh engine's serve under the profiler (device busy time, idle
    share, the engine kernels' device time by name), eager or graphed."""
    import contextlib
    from repro_torch.serving.generate import disable_graphs

    def serve():
        with contextlib.nullcontext() if graphed else disable_graphs():
            make_engine().serve(requests())
    return profile_window(torch, serve, warm=False, cpu=False)


def graph_report(label: str, eng, res) -> dict:
    """A graphed serve's executables: keys captured, replays, capture and
    warm-up seconds.  Fails unless the window
    key was captured and every decode window replayed, the stall rows'
    admission and the prefix rows' copy-on-write were captured."""
    stats = eng.graph_stats()
    if eng.mode != "continuous":
        return stats
    if eng._window_key not in eng._window.aot:
        fail(f"{label}: the decode window was not captured")
    if stats["replays"]["window"] != res["decode_dispatches"]:
        fail(f"{label}: {stats['replays']['window']} window replays for "
             f"{res['decode_dispatches']} decode windows")
    if eng.prefill == "stall" and eng._admit_key not in eng._admit.aot:
        fail(f"{label}: the stall admission was not captured")
    if eng.prefix_cache_enabled and eng._cow_key not in eng._cow.aot:
        fail(f"{label}: the copy-on-write page copy was not captured")
    return stats


#: the device kernels one launch of an engine kernel module runs
KERNEL_EVENTS = {"paged_decode_attention": ("paged_decode_split_kernel",
                                            "paged_decode_combine_kernel"),
                 "ragged_chunked_prefill": ("ragged_prefill_kernel",),
                 "rms_norm": ("rms_norm_kernel",),
                 "rope_kv": ("rope_kv_",)}


def same_serve(label: str, eager: dict, graphed: dict,
               extra=()) -> None:
    """A graphed serve must equal its eager twin: every request's tokens
    and the schedule (SCHEDULE_FIELDS and ``extra``).  Where both were
    profiled, the graphed serve's device kernels must be the eager one's
    (counted by name; a replay adds nothing to the wrappers' counts), and
    the eager serve's must be one per launch its wrappers counted.  Sets
    the graphed serve's ``graphs["pool_bytes"]``: its growth of
    ``memory_reserved`` less the eager serve's."""
    for f in ("tokens",) + SCHEDULE_FIELDS + tuple(extra):
        if eager[f] != graphed[f]:
            fail(f"{label}: graphed {f} differs from eager: "
                 f"{graphed[f]} vs {eager[f]}")
    if "graphs" in graphed:
        graphed["graphs"]["pool_bytes"] = (graphed["reserved_growth_bytes"]
                                           - eager["reserved_growth_bytes"])
    if "serve_profile" not in eager:
        return
    ev = [x["serve_profile"].get("kernel_events") for x in (eager, graphed)]
    if None in ev:
        fail(f"{label}: the profiler counted no device kernels")
    for name, tags in KERNEL_EVENTS.items():
        if name not in eager["launches"]:
            continue                         # not counted in this row
        for tag in tags:
            if ev[0][tag] != eager["launches"][name]:
                fail(f"{label}: eager ran {tag} {ev[0][tag]} times for "
                     f"{eager['launches'][name]} launches of {name}")
            if ev[1][tag] != ev[0][tag]:
                fail(f"{label}: graphed ran {tag} {ev[1][tag]} times, "
                     f"eager {ev[0][tag]}")


def engine_for(cfg, params, inputs, policy: str = "rt-lm", persona=None,
               **kw):
    """A fresh engine of phases 4, 5 and 8 (RT-LM policy, 16 slots, block
    16, bucket 128, EOS disabled, unless ``kw`` says otherwise) on the
    card; ``kw``: the row's arguments."""
    from repro_torch.core import scheduler as sched
    from repro_torch.serving.engine import ServingEngine
    persona, profile = persona or inputs["persona"], inputs["profile"]
    args = dict(num_slots=NUM_SLOTS, kv_block_size=BS,
                input_bucket=INPUT_BUCKET, max_new_tokens=MAX_NEW,
                eos_id=-1, device="cuda")
    args.update(kw)
    return ServingEngine(params, cfg,
                         sched.POLICIES[policy](persona,
                                                profile.policy_config()),
                         profile, **args)


#: phase 4's engine row: continuous, paged, chunked prefill, 4-step windows
PHASE4_ROW = dict(mode="continuous", kv="paged", prefill="chunked",
                  decode_steps=DECODE_STEPS, chunk_size=CHUNK)


def phase4_requests(inputs, classes=None) -> list:
    """Phase 4's 32 corpus requests at t = 0, caps from the corpus;
    ``classes``: a traffic class per request."""
    from repro_torch.serving.engine import Request
    classes = classes or [""] * N_REQUESTS
    return [Request(text=t.text, arrival=0.0, task_id=i,
                    max_new_tokens=t.out_lens["bart"],
                    traffic_class=classes[i])
            for i, t in enumerate(inputs["test"][:N_REQUESTS])]


def run_engine(torch, cfg, params, kmods, inputs) -> dict:
    """Phase 4's serve eager, then graphed, each on a fresh engine, then
    the same two serves under the profiler (graphed first).  The graphed
    serve must equal the eager one (``same_serve``: tokens, schedule, the
    device kernels counted by name), replay every decode window, and
    leave the card idle a smaller share of the serve."""

    def engine():
        return engine_for(cfg, params, inputs, **PHASE4_ROW)

    def requests():
        return phase4_requests(inputs)

    out = {"profile_train_s": inputs["profile_s"]}
    for mode in ("eager", "graphed"):
        eng = engine()
        res, wall, launches, grown, host = timed_serve(
            torch, eng, requests(), kmods, mode == "graphed")
        out[mode] = engine_serve(cfg, res, wall, launches)
        out[mode].update(host)
        out[mode]["reserved_growth_bytes"] = grown
        if mode == "graphed":
            out[mode]["graphs"] = graph_report("engine", eng, res)
        else:
            out[mode]["sim_inputs"] = sim_inputs(eng, res)
    for mode in ("graphed", "eager"):
        out[mode]["serve_profile"] = profiled_serve(
            torch, engine, requests, mode == "graphed")
    same_serve("engine", out["eager"], out["graphed"])
    idle = [out[m]["serve_profile"].get("device_idle_share")
            for m in ("eager", "graphed")]
    if None in idle or not idle[1] < idle[0]:
        fail(f"engine: graphed idle share {idle[1]} not below eager "
             f"{idle[0]}")
    for name, n in out["eager"]["launches"].items():
        if n <= 0:
            fail(f"engine: kernel {name} was never launched on the main "
                 "path")
    return out


def sim_inputs(eng, res) -> dict:
    """What the simulator needs to replay a continuous serve: each task in
    request order as the engine scheduled it (task id, its own ``u``,
    arrival, priority point, prompt words, realised output length) and
    the engine's settings, as ``simulate_continuous`` takes them."""
    tasks = sorted(res["tasks"], key=lambda t: t.task.task_id)
    return {"tasks": [(t.task.task_id, t.u, t.r, t.d, t.input_len,
                       t.task.out_len) for t in tasks],
            "settings": dict(
                xi=eng.xi, num_slots=eng.num_slots,
                kv_block_size=eng.kv_block_size,
                kv_num_blocks=eng.kv_num_blocks,
                prompt_len=eng.input_bucket, prefill=eng.prefill,
                chunk_size=eng.chunk_size, token_budget=eng.token_budget,
                decode_steps=eng.decode_steps)}


def engine_serve(cfg, res, wall, launches) -> dict:
    """Phase 4's numbers and checks of one serve: every request done with
    its cap and ids in the vocabulary, at most one prefill launch an
    iteration, N steps a window."""
    if len(res["tasks"]) != N_REQUESTS:
        fail(f"engine: {len(res['tasks'])} of {N_REQUESTS} requests done")
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
    return {
        "launches": launches,
        "wall_s": wall,
        "generated_tokens": gen_tokens,
        "generated_tokens_per_s": gen_tokens / wall,
        "ttft_p50_s": res["ttft_p50"], "ttft_p99_s": res["ttft_p99"],
        "itl_p50_s": res["itl_p50"], "itl_p99_s": res["itl_p99"],
        "lanes": lanes,
        "iterations": len(res["budget_trace"]),
        "peak_concurrency": res["peak_concurrency"],
        "tokens": {t.task.task_id: t.task.out_tokens for t in res["tasks"]},
        **{f: res[f] for f in SCHEDULE_FIELDS},
    }


# ---------------------------------------------------------------------------
# phase 5: the engine's other rows
# ---------------------------------------------------------------------------

N_ROW_REQUESTS = 16
PROMPT_WORDS = INPUT_BUCKET      # one word is one token: no left padding
SHARED_WORDS = 96                # six shared 16-token blocks

# the rows of the configuration matrix (docs/ARCHITECTURE.md) beside
# phase 4's continuous / paged / chunked one; the last is served twice
ENGINE_ROWS = (
    ("batch", dict(mode="batch", kv="contiguous", prefill="stall")),
    ("contiguous-stall", dict(mode="continuous", kv="contiguous",
                              prefill="stall", decode_steps=DECODE_STEPS)),
    ("paged-stall", dict(mode="continuous", kv="paged", prefill="stall",
                         decode_steps=DECODE_STEPS)),
    ("paged-stall-prefix", dict(mode="continuous", kv="paged",
                                prefill="stall", decode_steps=DECODE_STEPS,
                                prefix_cache=True)),
    ("paged-chunked-prefix-persist", dict(
        mode="continuous", kv="paged", prefill="chunked", chunk_size=CHUNK,
        decode_steps=DECODE_STEPS, prefix_cache=True,
        persist_prefix_cache=True)),
)


def prefix_workload(test) -> list:
    """N_ROW_REQUESTS texts of exactly PROMPT_WORDS words: the first
    SHARED_WORDS (a system prompt) common to all, the rest the request's
    own corpus text repeated; output caps from the corpus."""
    words = [w for t in test for w in t.text.split()]
    shared = words[:SHARED_WORDS]
    out = []
    for i, t in enumerate(test[:N_ROW_REQUESTS]):
        own = t.text.split()
        tail = own * (PROMPT_WORDS // len(own) + 1)
        out.append((" ".join(shared + tail[:PROMPT_WORDS - SHARED_WORDS]),
                    t.out_lens["bart"]))
    return out


def row_requests(work) -> list:
    from repro_torch.serving.engine import Request
    return [Request(text=text, arrival=0.0, task_id=i, max_new_tokens=c)
            for i, (text, c) in enumerate(work)]


def run_engine_rows(torch, cfg, params, kmods, inputs, card: str) -> dict:
    """Each row of ENGINE_ROWS serves the same 16 shared-prefix requests
    at full width (the persistent row twice, on one engine), eager and
    then graphed, each on a fresh engine, its kernels' launch counts reset
    just before each serve and read just after.  A one-serve row then
    serves once more in each mode, on a fresh engine, under the profiler
    (device busy time and idle share).  Every graphed serve must equal its
    eager twin (``same_serve``, prefix hits and free blocks included, and
    the device kernels counted by name where the row was profiled)."""
    work = prefix_workload(inputs["test"])
    caps = [max(1, min(c, MAX_NEW)) for _, c in work]
    rows = {}

    def engine(kw):
        return engine_for(cfg, params, inputs, **kw)

    def requests():
        return row_requests(work)

    for name, kw in ENGINE_ROWS:
        serves = 2 if kw.get("persist_prefix_cache") else 1
        for mode in ("eager", "graphed"):
            graphed = mode == "graphed"
            eng = engine(kw)
            for k in range(serves):
                label = name if serves == 1 else f"{name}-{k + 1}"
                res, wall, launches, grown, host = timed_serve(
                    torch, eng, requests(), kmods, graphed)
                row = engine_row(cfg, eng, res, caps, wall, launches, label,
                                 graphed)
                row.update(host)
                row["reserved_growth_bytes"] = grown
                if graphed:
                    row["graphs"] = graph_report(label, eng, res)
                if serves == 1:
                    row["serve_profile"] = profiled_serve(
                        torch, lambda: engine(kw), requests, graphed)
                rows.setdefault(label, {})[mode] = row
                print(f"engine row {label} {mode} [{card}]: "
                      f"{json.dumps(printable(row))}", flush=True)
            if eng.prefix_cache is not None:
                eng.prefix_cache.clear()
            if eng.allocator is not None:
                eng.allocator.check_no_leaks()
    for label, pair in rows.items():
        same_serve(f"engine row {label}", pair["eager"], pair["graphed"],
                   ("prefix_hit_blocks", "free_blocks_after"))

    def same(a, b):
        ta, tb = rows[a]["graphed"]["tokens"], rows[b]["graphed"]["tokens"]
        return sum(ta[i] == tb[i] for i in range(len(work))) / len(work)

    # a chunked serve admits all 16 requests before any prefill lands, so
    # the persistent row's first serve may find its cache empty
    hits = [rows[f"{ENGINE_ROWS[-1][0]}-{k}"]["graphed"]["prefix_hit_blocks"]
            for k in (1, 2)]
    if rows["paged-stall-prefix"]["graphed"]["prefix_hit_blocks"] <= 0 \
            or hits[1] <= 0:
        fail("engine rows: a prefix row found no prefix hit")
    if not hits[1] > hits[0]:
        fail(f"engine rows: the persistent cache's second serve hit "
             f"{hits[1]} blocks, its first {hits[0]}")
    return {"rows": rows, "token_identity": {
        "paged_vs_contiguous_stall": same("paged-stall", "contiguous-stall"),
        "prefix_on_vs_off_stall": same("paged-stall-prefix", "paged-stall"),
        "batch_vs_contiguous_stall": same("batch", "contiguous-stall")}}


def engine_row(cfg, eng, res, caps, wall, launches, label,
               graphed: bool) -> dict:
    """One serve's numbers and checks: every request done with its cap,
    ids in the vocabulary, the pool back to its free blocks but the prefix
    cache's pinned ones, the paged decode kernel launched on every paged
    row and the fused prefill on the prefix rows (eager serves: a graphed
    serve's replays are counted by ``same_serve`` from its profile)."""
    if len(res["tasks"]) != len(caps):
        fail(f"engine row {label}: {len(res['tasks'])} of {len(caps)} "
             "requests done")
    gen = 0
    for t in res["tasks"]:
        r = t.task
        if r.out_len != caps[r.task_id] or len(r.out_tokens) != r.out_len:
            fail(f"engine row {label}: request {r.task_id} produced "
                 f"{r.out_len} tokens, expected {caps[r.task_id]}")
        if not all(0 <= x < cfg.vocab_size for x in r.out_tokens):
            fail(f"engine row {label}: an id outside the vocabulary")
        gen += r.out_len
    pc = eng.prefix_cache
    free = eng.allocator.num_free if eng.allocator is not None else None
    if eng.kv == "paged":
        pinned = pc.num_cached_blocks if pc is not None else 0
        if free + pinned != eng.kv_num_blocks:
            fail(f"engine row {label}: {free} free + {pinned} cached of "
                 f"{eng.kv_num_blocks} blocks: a block leaked")
        if not graphed and launches["paged_decode_attention"] <= 0:
            fail(f"engine row {label}: the paged decode kernel was never "
                 "launched")
    if not graphed and pc is not None \
            and launches["ragged_chunked_prefill"] <= 0:
        fail(f"engine row {label}: the fused prefill kernel was never "
             "launched")
    if eng.mode == "batch":
        iterations = len(res["prefill_dispatch_trace"])      # batches
    elif eng.prefill == "stall":
        iterations = len(res["decode_dispatch_trace"])      # windows
    else:
        iterations = len(res["budget_trace"])
    return {
        "wall_s": wall, "generated_tokens": gen,
        "generated_tokens_per_s": gen / wall,
        "ttft_p50_s": res["ttft_p50"], "ttft_p99_s": res["ttft_p99"],
        "itl_p50_s": res["itl_p50"], "itl_p99_s": res["itl_p99"],
        "iterations": iterations,
        "launches": launches,
        "prefix_hit_blocks": pc.hit_blocks if pc is not None else 0,
        "free_blocks_after": free,
        "peak_concurrency": res["peak_concurrency"],
        "prefill_stall_s": res["prefill_stall_s"],
        "tokens": {t.task.task_id: t.task.out_tokens for t in res["tasks"]},
        **{f: res[f] for f in SCHEDULE_FIELDS},
    }


# ---------------------------------------------------------------------------
# phase 6: observability
# ---------------------------------------------------------------------------

#: phase 4's two traffic classes (``core.workload``): interactive requests
#: held to TTFT and ITL targets, batch ones to an end-to-end target
TRAFFIC = {"interactive": {"slo": {"ttft_s": 2.5, "itl_s": 0.02}},
           "batch": {"slo": {"e2e_s": 30.0}}}
#: the health snapshots' cadence, in decode steps
SNAPSHOT_STEPS = 16
FAULT_KINDS = {"timeout", "shed", "retry", "failover", "replica_down",
               "replica_up", "dead_letter"}


def run_obs(torch, cfg, params, kmods, inputs, eres: dict, rres: dict,
            card: str) -> dict:
    """Phase 4's workload (its requests in two traffic classes) and then
    each phase-5 row, served graphed on a fresh engine with
    ``obs=Observability(...)`` (the persistent row twice, each serve into
    its own bundle), the kernels' launch counts reset just before each
    serve and read just after.  ``obs_row`` holds each traced serve to its
    row's untraced graphed serve and to its own result."""
    from repro_torch.core import workload
    from repro_torch.obs import Observability
    classes = workload.make_traffic_classes(TRAFFIC)

    def bundle(targets):
        # the trace, the metrics, the SLO monitor over ``targets``, the
        # calibration ledger and health snapshots
        return Observability(slo=targets, calibration=True,
                             snapshot_every_steps=SNAPSHOT_STEPS)

    out = {}
    cls = workload.assign_classes(N_REQUESTS, classes, seed=0)
    eng = engine_for(cfg, params, inputs, **PHASE4_ROW,
                     obs=bundle(workload.slo_targets(classes)))
    res, wall, launches, _, host = timed_serve(
        torch, eng, phase4_requests(inputs, cls), kmods, True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"engine obs: kernel {name} was never launched")
    if eng.allocator.num_free != eng.kv_num_blocks:
        fail(f"engine obs: {eng.allocator.num_free} of {eng.kv_num_blocks} "
             "blocks free after the serve")
    rec = engine_serve(cfg, res, wall, launches)
    rec.update(host)
    out["engine"] = obs_row("engine", eng, res, rec, eres["graphed"], card)
    work = prefix_workload(inputs["test"])
    caps = [max(1, min(c, MAX_NEW)) for _, c in work]
    for name, kw in ENGINE_ROWS:
        serves = 2 if kw.get("persist_prefix_cache") else 1
        eng = engine_for(cfg, params, inputs, **kw)
        for k in range(serves):
            label = name if serves == 1 else f"{name}-{k + 1}"
            eng.obs = bundle(True)          # one default class
            res, wall, launches, _, host = timed_serve(
                torch, eng, row_requests(work), kmods, True)
            rec = engine_row(cfg, eng, res, caps, wall, launches, label,
                             True)
            rec.update(host)
            out[label] = obs_row(label, eng, res, rec,
                                 rres["rows"][label]["graphed"], card)
        if eng.prefix_cache is not None:
            eng.prefix_cache.clear()
        if eng.allocator is not None:
            eng.allocator.check_no_leaks()
    return out


def obs_row(label: str, eng, res, rec: dict, base: dict, card: str) -> dict:
    """The checks and numbers of one traced serve.  It fails unless (1) its
    tokens, schedule, prefix hits and free blocks equal the untraced
    graphed serve's (``base``); (2) every event kind is in ``EVENT_KINDS``
    and none is a fault kind; (3) the counters equal the result's mirrors
    and no fallback was counted; (4) the JSONL written to ``build/``
    reloads with the same parity events, and its timelines give the
    result's TTFT (and, with decode windows, ITL) p50 / p99 within the
    histogram's relative error; (5) the calibration ledger counts every
    request, its error sum Σ(u - length); (6) each traffic class's SLO
    counts are its requests'.  Prints one ``engine obs`` line."""
    from repro_torch.obs import (EVENT_KINDS, SLO_METRICS, Histogram,
                                 TraceRecorder, timelines)
    ob = eng.obs
    for f in ("tokens",) + SCHEDULE_FIELDS + ("prefix_hit_blocks",
                                              "free_blocks_after"):
        if f in base and rec[f] != base[f]:
            fail(f"engine obs {label}: traced {f} differs from the "
                 f"untraced serve's: {rec[f]} vs {base[f]}")
    kinds = {e.kind for e in ob.trace.events}
    if not kinds <= EVENT_KINDS or kinds & FAULT_KINDS:
        fail(f"engine obs {label}: event kinds {sorted(kinds)}")
    c = ob.metrics.counters()
    n = len(res["tasks"])
    pc = eng.prefix_cache
    mirrors = {"sched.completions": n,
               "prefill.dispatches": res["prefill_dispatches"],
               "decode.dispatches": res["decode_dispatches"],
               "decode.steps": res["decode_steps_executed"],
               "prefix.hit_blocks": pc.hit_blocks if pc is not None else 0,
               "prefix.cow_copies": res["cow_copies"]}
    for k, want in mirrors.items():
        if c.get(k, 0) != want:
            fail(f"engine obs {label}: counter {k} = {c.get(k, 0)}, the "
                 f"result says {want}")
    if res["fallback_events"] != 0 or ob.trace.dropped:
        fail(f"engine obs {label}: {res['fallback_events']} fallbacks, "
             f"{ob.trace.dropped} dropped events")
    stem = ROOT / "build" / f"obs_{label}"
    stem.parent.mkdir(exist_ok=True)
    back = TraceRecorder.load_jsonl(ob.trace.to_jsonl(f"{stem}.jsonl"))
    ob.trace.export_perfetto(f"{stem}.perfetto.json")
    if back.parity_events() != ob.trace.parity_events():
        fail(f"engine obs {label}: the JSONL does not round-trip")
    ttft, itl = Histogram(), Histogram()
    for t in timelines(back).values():
        ttft.record(t.ttft)
        for v in t.itls:
            itl.record(v)
    tol = 2 * (Histogram.GROWTH ** 0.5 - 1.0)
    checks = [("ttft", ttft)] + ([("itl", itl)] if res["decode_dispatches"]
                                 else [])
    for name, h in checks:
        for q in (50, 99):
            got, want = h.quantile(q / 100), res[f"{name}_p{q}"]
            if abs(got - want) > tol * abs(want):
                fail(f"engine obs {label}: trace {name} p{q} {got} vs "
                     f"result {want}")
    cal = ob.calibration
    err = sum(t.u - t.task.out_len for t in res["tasks"])
    if cal.count != n or abs(cal.err_sum - err) > 1e-6 * max(1.0, abs(err)):
        fail(f"engine obs {label}: calibration count {cal.count}, error "
             f"sum {cal.err_sum} vs {err}")
    slo = ob.slo.parity_counters()
    by_cls: dict = {}
    for t in res["tasks"]:
        k = ob.slo.resolve(t.task.traffic_class)
        want = by_cls.setdefault(k, {"completions": 0, "ttft": 0, "e2e": 0,
                                     "queue_wait": 0, "itl": 0})
        for m in ("completions", "ttft", "e2e", "queue_wait"):
            want[m] += 1
        want["itl"] += t.task.out_len - 1
    for k, want in by_cls.items():
        for m, v in want.items():
            key = (f"slo.{k}.completions" if m == "completions"
                   else f"slo.{k}.{m}.total")
            if slo.get(key, 0) != v:
                fail(f"engine obs {label}: {key} = {slo.get(key, 0)}, "
                     f"{v} requests' worth")
    spans: dict = {}
    for sp in ob.trace.spans:
        spans[sp.name] = spans.get(sp.name, 0.0) + sp.dur
    waits = ob.metrics.histogram("pipeline.collect_wait_s")
    row = {
        "wall_s": rec["wall_s"], "untraced_wall_s": base["wall_s"],
        "obs_overhead_s": res["obs_overhead_s"],
        "obs_overhead_share": res["obs_overhead_s"] / rec["wall_s"],
        "events": ob.event_count(), "spans": len(ob.trace.spans),
        "snapshots": len(ob.health_trace),
        "collect_waits": waits.count,
        "collect_wait_p50_s": waits.quantile(0.50),
        "collect_wait_p99_s": waits.quantile(0.99),
        "collect_wait_sum_s": waits.total,
        "span_sum_s": spans,
        "graph_warm_s": eng.graph_warm_s,
        **{k: rec[k] for k in ("gc_before_s", "gc_pauses", "gc_pause_s")},
        "attainment": {k: {m: v[m]["frac"] for m in SLO_METRICS
                           if v[m]["total"]}
                       for k, v in res["slo_attainment"].items()},
        "calibration_mae": cal.mae, "calibration_bias": cal.bias,
        "launches": rec["launches"],
        "counters": c,
    }
    print(f"engine obs {label} [{card}]: {json.dumps(row)}", flush=True)
    return row


# ---------------------------------------------------------------------------
# phase 7: replicas and faults
# ---------------------------------------------------------------------------

#: replicas on the one card, sharing the parameters
POOL_R = 4
#: 7b's fault plan: replica 3 crashes at its step 8 (two 4-step windows in,
#: its requests active), replica 2 runs at half speed over steps 0-16, the
#: pool's last placement fails once, and the pre-admission pass times out
#: the doomed class and sheds the bulk class past four queued requests
CRASH_REPLICA, CRASH_STEP = 3, 8
SLOW = (2, 0, 16, 2.0)
TRANSIENT_AT = N_REQUESTS - 1
RETRY_BUDGET = 3
SHED_DEPTH = 4
#: 7b's classes, judgment-invariant: no end-to-end target (never late) or
#: -1.0 (late at the first check), so no decision reads the wall clock
FAULT_CLASSES = ("interactive", "batch", "doomed")


def pool_for(cfg, params, inputs, router, faults=None, obs=None, **kw):
    """A fresh pool of POOL_R engines on the card (phase 4's engine
    settings, one RT-LM policy, one bundle), behind ``router``."""
    from repro_torch.core import scheduler as sched
    from repro_torch.serving.replica import ReplicatedEngine
    persona, profile = inputs["persona"], inputs["profile"]
    policy = sched.POLICIES["rt-lm"](persona, profile.policy_config())
    return ReplicatedEngine(params, cfg, policy, profile, replicas=POOL_R,
                            router=router, faults=faults, obs=obs,
                            num_slots=NUM_SLOTS, kv_block_size=BS,
                            input_bucket=INPUT_BUCKET,
                            max_new_tokens=MAX_NEW, eos_id=-1,
                            device="cuda", **kw)


def time_rounds(torch, pool) -> list:
    """Wrap each replica's ``serve`` to record every round it serves: its
    wall seconds (to a synchronize), the graphs it captured and their
    capture seconds.  Returns the per-replica lists."""
    rounds = [[] for _ in pool.engines]
    for r, eng in enumerate(pool.engines):
        def serve(requests, _serve=eng.serve, _eng=eng, _r=r, **kw):
            t0 = time.perf_counter()
            res = _serve(requests, **kw)
            torch.cuda.synchronize()
            st = _eng.graph_stats()
            rounds[_r].append({"wall_s": time.perf_counter() - t0,
                               "graphs": sum(st["graphs"].values()),
                               "capture_s": st["capture_s"]})
            return res
        eng.serve = serve
    return rounds


def pool_serve(torch, pool, requests, kmods, graphed: bool) -> dict:
    """One timed serve of a pool (``timed_serve``), with each replica's
    rounds.  Returns the result, the numbers and the per-request tokens."""
    from repro_torch.obs.metrics import Histogram
    rounds = time_rounds(torch, pool)
    res, wall, launches, _, host = timed_serve(torch, pool, requests, kmods,
                                               graphed)
    tasks = [t for rr in res["per_replica"] if rr is not None
             for t in rr["tasks"]]
    ttft, itl = Histogram(), Histogram()
    for t in tasks:
        times = t.task.token_times
        ttft.record(times[0] - t.r)
        for a, b in zip(times, times[1:]):
            itl.record(b - a)
    gen = sum(t.task.out_len for t in tasks)
    capture = sum(x["capture_s"] for rl in rounds for x in rl)
    row = {
        "wall_s": wall, "generated_tokens": gen,
        "generated_tokens_per_s": gen / wall,
        "ttft_p50_s": ttft.quantile(0.5), "ttft_p99_s": ttft.quantile(0.99),
        "itl_p50_s": itl.quantile(0.5), "itl_p99_s": itl.quantile(0.99),
        "capture_s": capture, "capture_share": capture / wall,
        "replicas": [{"wall_s": sum(x["wall_s"] for x in rl),
                      "rounds": len(rl),
                      "graphs": sum(x["graphs"] for x in rl),
                      "capture_s": sum(x["capture_s"] for x in rl)}
                     for rl in rounds],
        "placements": res["placements"],
        "placement_counts": res["placement_counts"],
        "launches": launches,
        **{k: host[k] for k in ("gc_before_s", "gc_pauses", "gc_pause_s")},
        "tokens": {t.task.task_id: t.task.out_tokens for t in tasks},
    }
    if "retries" in res:
        row["faults"] = {k: res[k] for k in ("timed_out", "shed", "retries",
                                             "failovers", "dead_lettered")}
        row["failover_placements"] = res["failover_placements"]
        row["fault_ids"] = {k: [tid for rr in res["per_replica"]
                                if rr is not None for tid in rr[f"{k}_ids"]]
                            for k in ("timed_out", "shed")}
    for r, eng in enumerate(pool.engines):
        if eng.allocator is not None \
                and eng.allocator.num_free != eng.kv_num_blocks:
            fail(f"engine pool: replica {r} holds "
                 f"{eng.kv_num_blocks - eng.allocator.num_free} blocks "
                 "after the serve")
    if not graphed and launches["paged_decode_attention"] <= 0:
        fail("engine pool: the paged decode kernel was never launched")
    return res, row


def pool_events(ob) -> dict:
    """A pool bundle's parity view: the route events and each replica's
    stream."""
    ev = ob.trace.parity_events()
    return {"route": [e for e in ev if e[0] == "route"],
            "replicas": [ob.trace.parity_events(replica=r)
                         for r in range(POOL_R)],
            "kinds": sorted({e[0] for e in ev})}


def run_pool(torch, cfg, params, kmods, inputs, card: str) -> dict:
    """7a: phase 4's row and 32 requests (phase 6's two classes) on four
    replicas behind an rtlm router with replica 3 the bulk slice, traced,
    eager and then graphed, each on a fresh pool; each replica's group
    once more on a fresh single engine, graphed.  7b: the stall row on
    four replicas behind ``least_queue`` under the fault plan above, eager
    and then graphed.  Prints one ``engine pool`` line a serve."""
    from repro_torch.core import workload
    from repro_torch.obs import Observability, SLOSpec
    from repro_torch.serving.engine import Request
    from repro_torch.serving.faults import (CrashFault, FaultPlan,
                                            RetryPolicy, ShedPolicy,
                                            SlowFault, TransientFault)
    from repro_torch.serving.router import Router
    out = {}

    # -- 7a: the unfaulted pool
    classes = workload.make_traffic_classes(TRAFFIC)
    cls = workload.assign_classes(N_REQUESTS, classes, seed=0)
    runs = {}
    for mode in ("eager", "graphed"):
        ob = Observability(slo=workload.slo_targets(classes))
        pool = pool_for(cfg, params, inputs,
                        Router(POOL_R, "rtlm", bulk_replicas=(3,),
                               bulk_classes=("batch",)),
                        obs=ob, **PHASE4_ROW)
        res, row = pool_serve(torch, pool, phase4_requests(inputs, cls),
                              kmods, mode == "graphed")
        runs[mode] = (res, row, pool_events(ob))
        out[f"7a_{mode}"] = row
        print(f"engine pool 7a {mode} [{card}]: "
              f"{json.dumps(printable(row))}", flush=True)
    (res, row, ev), (gres, grow, gev) = runs["eager"], runs["graphed"]
    if row["launches"]["ragged_chunked_prefill"] <= 0:
        fail("engine pool 7a: the fused prefill kernel was never launched")
    caps = {t.task_id: max(1, min(t.max_new_tokens, MAX_NEW))
            for t in phase4_requests(inputs)}
    for mode, (pres, prow, pev) in runs.items():
        toks = prow["tokens"]
        if set(toks) != set(caps) \
                or any(len(v) != caps[k] for k, v in toks.items()):
            fail(f"engine pool 7a {mode}: a request was not done with its "
                 "cap")
        if set(pev["kinds"]) & FAULT_KINDS:
            fail(f"engine pool 7a {mode}: fault events {pev['kinds']}")
        for r in range(POOL_R):
            if pres["placement_counts"][r] and not pev["replicas"][r]:
                fail(f"engine pool 7a {mode}: replica {r}'s stream carries "
                     "no label")
    for i, c in enumerate(cls):
        if (res["placements"][i] == 3) != (c == "batch"):
            fail(f"engine pool 7a: request {i} of class {c} on replica "
                 f"{res['placements'][i]}")
    if ev != gev or row["tokens"] != grow["tokens"]:
        fail("engine pool 7a: the graphed pool differs from the eager one "
             "(placements, route scores, streams or tokens)")
    reqs = phase4_requests(inputs, cls)
    for r in range(POOL_R):
        group = [q for q, p in zip(reqs, gres["placements"]) if p == r]
        single = engine_for(cfg, params, inputs, **PHASE4_ROW)
        want = single.serve(group)
        got = gres["per_replica"][r]
        for f in ("completion_order", "budget_trace",
                  "prefill_dispatch_trace", "decode_dispatch_trace"):
            if got[f] != want[f]:
                fail(f"engine pool 7a: replica {r}'s {f} differs from a "
                     "single engine's serve of its group")
        if {t.task.task_id: t.task.out_tokens for t in got["tasks"]} \
                != {t.task.task_id: t.task.out_tokens
                    for t in want["tasks"]}:
            fail(f"engine pool 7a: replica {r}'s tokens differ from a "
                 "single engine's serve of its group")

    # -- 7b: the faulted pool
    fcls = [FAULT_CLASSES[(i // POOL_R) % 3] for i in range(N_REQUESTS)]
    fcaps = [64 if i % POOL_R == CRASH_REPLICA else
             t.out_lens["bart"]
             for i, t in enumerate(inputs["test"][:N_REQUESTS])]
    plan = FaultPlan(crashes=(CrashFault(CRASH_REPLICA, CRASH_STEP),),
                     slowdowns=(SlowFault(*SLOW),),
                     transients=(TransientFault(at_placement=TRANSIENT_AT),),
                     retry=RetryPolicy(budget=RETRY_BUDGET),
                     shed=ShedPolicy(queue_depth=SHED_DEPTH,
                                     bulk_classes=("batch",)),
                     deadlines=True)
    fruns = {}
    for mode in ("eager", "graphed"):
        ob = Observability(slo={"interactive": SLOSpec(),
                                "batch": SLOSpec(),
                                "doomed": SLOSpec(e2e_s=-1.0)})
        pool = pool_for(cfg, params, inputs, Router(POOL_R, "least_queue"),
                        faults=plan, obs=ob, mode="continuous", kv="paged",
                        prefill="stall", decode_steps=DECODE_STEPS)
        reqs = [Request(text=t.text, arrival=0.0, task_id=i,
                        max_new_tokens=fcaps[i], traffic_class=fcls[i])
                for i, t in enumerate(inputs["test"][:N_REQUESTS])]
        res, row = pool_serve(torch, pool, reqs, kmods, mode == "graphed")
        fc = row["faults"]
        c = ob.metrics.counters()
        for k in ("timed_out", "shed", "retries", "failovers",
                  "dead_lettered"):
            if c.get(f"faults.{k}", 0) != fc[k]:
                fail(f"engine pool 7b {mode}: faults.{k} = "
                     f"{c.get(f'faults.{k}', 0)}, the result says {fc[k]}")
        # conservation: completed, timed out, shed or dead-lettered, once
        ids = (sum(row["fault_ids"].values(), [])
               + [tid for o in res["completion_orders"] for tid in o])
        if len(set(ids)) != len(ids) or not set(ids) <= set(
                range(N_REQUESTS)) \
                or len(ids) + fc["dead_lettered"] != N_REQUESTS:
            fail(f"engine pool 7b {mode}: {len(ids)} outcomes and "
                 f"{fc['dead_lettered']} dead letters for {N_REQUESTS} "
                 "requests")
        crashed = res["per_replica"][CRASH_REPLICA]
        if not crashed["crashed"] or not crashed["survivor_ids"]:
            fail(f"engine pool 7b {mode}: replica {CRASH_REPLICA} did not "
                 "crash with survivors")
        if any(dst == CRASH_REPLICA or src != CRASH_REPLICA
               for _, src, dst in res["failover_placements"]):
            fail(f"engine pool 7b {mode}: failover placements "
                 f"{res['failover_placements']}")
        if not (fc["failovers"] and fc["retries"] > fc["failovers"]
                and fc["timed_out"] and fc["shed"]):
            fail(f"engine pool 7b {mode}: a mechanism did not fire: {fc}")
        for t in (t for rr in res["per_replica"] if rr is not None
                  for t in rr["tasks"]):
            want = max(1, min(fcaps[t.task.task_id], MAX_NEW))
            if t.task.out_len != want:
                fail(f"engine pool 7b {mode}: request {t.task.task_id} "
                     f"produced {t.task.out_len} tokens, expected {want}")
        row["crashed_survivors"] = crashed["survivor_ids"]
        fruns[mode] = (row, pool_events(ob))
        out[f"7b_{mode}"] = row
        print(f"engine pool 7b {mode} [{card}]: "
              f"{json.dumps(printable(row))}", flush=True)
    (row, ev), (grow, gev) = fruns["eager"], fruns["graphed"]
    for f in ("placements", "failover_placements", "faults", "fault_ids",
              "tokens", "crashed_survivors"):
        if row[f] != grow[f]:
            fail(f"engine pool 7b: graphed {f} differs from eager")
    if ev != gev:
        fail("engine pool 7b: the graphed pool's parity events differ from "
             "the eager one's")
    out["plan"] = {"crash": [CRASH_REPLICA, CRASH_STEP], "slow": list(SLOW),
                   "transient_at": TRANSIENT_AT, "retry_budget": RETRY_BUDGET,
                   "shed_depth": SHED_DEPTH, "classes": list(FAULT_CLASSES)}
    return out


# ---------------------------------------------------------------------------
# phase 8: the MoE and sliding-window families
# ---------------------------------------------------------------------------

#: 8a: kimi-k2-1t-a32b at full width, cut to its dense prefix layer and one
#: MoE layer (18.8 B parameters: 37.5 GB of bf16 weights on the 80 GB card;
#: each further MoE layer is 33.8 GB of experts)
KIMI_LAYERS = 2
FAMILY_REQUESTS = 16
#: every phase-8 request's output cap
FAMILY_MAX_NEW = 32
#: 8b / 8c: prompts left-padded to a bucket past the 4096-token window
WINDOW_BUCKET = 4608
WINDOW_REQUESTS = 8
#: 8c: mixtral-8x22b cut to two of its 56 layers (each 4.8 GB of experts)
MIXTRAL_LAYERS = 2
#: 8b / 8c rows; FIFO keeps batch mode at 8 rows of 4608 tokens (RT-LM's
#: consolidation would take 14, whose windowed prefill scores alone need
#: 9.4 GB a query chunk)
WINDOW_ROWS = {
    "h2o-danube-3-4b": (
        ("batch", dict(mode="batch", kv="contiguous", prefill="stall")),
        ("contiguous-stall", dict(mode="continuous", kv="contiguous",
                                  prefill="stall",
                                  decode_steps=DECODE_STEPS))),
    "mixtral-8x22b": (
        ("contiguous-stall", dict(mode="continuous", kv="contiguous",
                                  prefill="stall",
                                  decode_steps=DECODE_STEPS)),),
}


def family_model(torch, name: str, layers=None):
    """The published config at full width, its depth cut to ``layers``
    where one card's memory forces it, with seeded random bf16 weights;
    prints the model line with the cut."""
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.models import transformer
    full = configs.get_config(name)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          num_layers=layers)
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    info = {"name": name, "layers": cfg.num_layers,
            "published_layers": full.num_layers,
            "kinds": list(transformer.layer_kinds(cfg)),
            "params": sum(p.numel() for p in leaves),
            "param_bytes": sum(p.numel() * p.element_size() for p in leaves),
            "init_s": time.perf_counter() - t0,
            "memory_allocated_bytes": torch.cuda.memory_allocated()}
    cut = ("whole" if layers is None else
           f"depth cut to {cfg.num_layers} of {full.num_layers} layers")
    kinds = info["kinds"]
    kinds = (", ".join(kinds) if len(kinds) <= 4 else
             f"{kinds[0]} ... {kinds[-1]}: " + ", ".join(
                 f"{kinds.count(k)} {k}" for k in sorted(set(kinds))))
    if cfg.family in ("vlm", "encdec"):
        shape = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                 f"{cfg.head_dim}, vocab {cfg.vocab_size}, " + (
                     f"{cfg.num_patch_tokens} patch tokens"
                     if cfg.frontend == "vision" else
                     f"{cfg.num_encoder_layers} encoder layers over "
                     f"{cfg.encoder_seq_len} frames"))
    elif cfg.family == "ssm":
        shape = (f"SSD {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, state "
                 f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, conv "
                 f"{cfg.ssm_conv_width}")
    elif cfg.family == "hybrid":
        shape = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                 f"{cfg.head_dim}, local window {cfg.local_window}, lru "
                 f"width {cfg.lru_width}")
    else:
        shape = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                 f"{cfg.head_dim}, window {cfg.window}, experts "
                 f"{cfg.num_experts or '-'} top-"
                 f"{cfg.experts_per_token or '-'}")
    print(f"model: {name}, {cut} ({kinds}), d_model {cfg.d_model}, "
          f"{shape}, {info['params'] / 1e9:.3f} B params, "
          f"{info['param_bytes'] / 1e9:.2f} GB, init {info['init_s']:.1f} s",
          flush=True)
    return cfg, params, info


def free_card(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


class MoeDrops:
    """Records ``moe_drop_frac`` of every MoE layer call that routes more
    than one token a row (the prefills: the fused one, an admission, a
    batch) while open; a measurement hook of this script, opened around
    eager serves only (a graph's replay runs no Python)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.local, self.drops = moe, moe.apply_moe_local, []

        def recording(params, x, cfg):
            out, aux = self.local(params, x, cfg)
            if x.shape[1] > 1:
                self.drops.append((x.shape[0] * x.shape[1],
                                   aux["moe_drop_frac"]))
            return out, aux

        moe.apply_moe_local = recording
        return self

    def __exit__(self, *exc):
        self.mod.apply_moe_local = self.local

    def summary(self) -> dict:
        if not self.drops:
            return {"calls": 0}
        fr = [float(d) for _, d in self.drops]
        return {"calls": len(fr), "mean": statistics.fmean(fr),
                "max": max(fr),
                "tokens_routed": sorted({t for t, _ in self.drops})}


def family_serves(torch, label: str, cfg, make_engine, requests, caps,
                  kmods, card: str, profile_graphed: bool = False) -> dict:
    """One row of phases 8 and 9: an eager serve (MoE drops recorded) and a
    graphed one, each on a fresh engine; the graphed must equal the eager
    (tokens and schedule).  ``profile_graphed``: one more graphed serve
    under the profiler, whose engine kernels must have run, by name, as
    often as the eager serve's wrappers launched them."""
    out = {}
    for mode in ("eager", "graphed"):
        graphed = mode == "graphed"
        eng = make_engine()
        drops = MoeDrops()
        with drops if not graphed else contextlib.nullcontext():
            res, wall, launches, grown, host = timed_serve(
                torch, eng, requests(), kmods, graphed)
        row = engine_row(cfg, eng, res, caps, wall, launches, label,
                         graphed)
        row.update(host)
        row["reserved_growth_bytes"] = grown
        if graphed:
            row["graphs"] = graph_report(label, eng, res)
        else:
            row["moe_drop_frac"] = (drops.summary() if cfg.family == "moe"
                                    else None)
            if cfg.family == "moe" and row["moe_drop_frac"]["calls"] == 0:
                fail(f"{label}: the eager serve recorded no MoE prefill "
                     "(moe.apply_moe_local is no longer the routed call)")
        if eng.allocator is not None:
            eng.allocator.check_no_leaks()
        out[mode] = row
        del eng
        free_card(torch)
    same_serve(label, out["eager"], out["graphed"])
    if profile_graphed:
        prof = profiled_serve(torch, make_engine, requests, True)
        events, want = prof.get("kernel_events"), out["eager"]["launches"]
        if events is None:
            fail(f"{label}: the profiler counted no device kernels")
        for name, tags in KERNEL_EVENTS.items():
            if name not in want:
                continue                     # not counted in this row
            if want[name] <= 0:
                fail(f"{label}: kernel {name} was never launched")
            for tag in tags:
                if events[tag] != want[name]:
                    fail(f"{label}: the graphed serve ran {tag} "
                         f"{events[tag]} times for {want[name]} eager "
                         f"launches of {name}")
        out["graphed"]["serve_profile"] = prof
        free_card(torch)
    for mode in ("eager", "graphed"):
        row = out[mode]
        line = {k: row.get(k) for k in (
            "wall_s", "generated_tokens_per_s", "ttft_p50_s", "ttft_p99_s",
            "itl_p50_s", "itl_p99_s", "iterations", "launches")}
        line["capture_s"] = (row["graphs"]["capture_s"]
                             if "graphs" in row else None)
        # a replay runs no Python: the graphed serve routes as the eager
        line["moe_drop_frac_of_eager_prefills"] = \
            out["eager"]["moe_drop_frac"]
        if "serve_profile" in row:
            line["serve_profile"] = row["serve_profile"]
        print(f"engine family {label} {mode} [{card}]: {json.dumps(line)}",
              flush=True)
    return out


def run_kimi(torch, F, kmods, inputs, card: str, serve_kmods) -> dict:
    """8a: kimi-k2-1t-a32b (2 layers) — the two engine kernels at its
    heads (D 112) against their plain versions, phase 3's model check,
    then phase 4's row serving 16 requests eager and graphed, the launches
    of ``serve_kmods`` (the attention kernels and the fused pointwise
    ones) counted."""
    cfg, params, info = family_model(torch, "kimi-k2-1t-a32b", KIMI_LAYERS)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    out = {"model": info, "kernels_d112": {}}
    for m, check in zip(kmods, (check_decode, check_ragged)):
        r = check(torch, F, m, heads=heads)
        r.pop("ops")
        out["kernels_d112"][m.NAME] = r
        print(f"kernel {m.NAME} at {cfg.name}'s heads [{card}]: "
              f"{json.dumps(r)}", flush=True)
    out["model_check"] = check_model(torch, cfg, params)
    print(f"model check {cfg.name}: {json.dumps(out['model_check'])}",
          flush=True)
    requests = lambda: phase4_requests(inputs)[:FAMILY_REQUESTS]  # noqa
    caps = [max(1, min(r.max_new_tokens, FAMILY_MAX_NEW))
            for r in requests()]
    out["serves"] = family_serves(
        torch, "kimi-k2-1t-a32b paged-chunked", cfg,
        lambda: engine_for(cfg, params, inputs,
                           max_new_tokens=FAMILY_MAX_NEW, **PHASE4_ROW),
        requests, caps, serve_kmods, card, profile_graphed=True)
    launches = out["serves"]["eager"]["launches"]
    if min(launches.values()) <= 0:
        fail(f"kimi-k2: an engine kernel was never launched: {launches}")
    return out


def contiguous_serves(torch, cfg, params, rows, bucket: int, n: int,
                      policy: str, refusal: str, kmods, inputs,
                      card: str) -> dict:
    """Phases 8b, 8c and 9: ``n`` corpus prompts left-padded to ``bucket``
    with caps of FAMILY_MAX_NEW, on ``n`` slots under ``policy``, through
    each of ``rows`` eager and graphed (``family_serves``); then
    ``kv="paged"`` must raise the reference's refusal, of which
    ``refusal`` is part."""
    from repro_torch.serving.engine import Request
    persona = dataclasses.replace(inputs["persona"], batch_size=n)
    texts = inputs["test"][:n]

    def requests():
        return [Request(text=t.text, arrival=0.0, task_id=i,
                        max_new_tokens=FAMILY_MAX_NEW)
                for i, t in enumerate(texts)]

    def engine(kw):
        return engine_for(cfg, params, inputs, policy=policy,
                          persona=persona, num_slots=n, input_bucket=bucket,
                          max_new_tokens=FAMILY_MAX_NEW, **kw)

    out = {"rows": {}}
    for row, kw in rows:
        out["rows"][row] = family_serves(
            torch, f"{cfg.name} {row}", cfg, lambda kw=kw: engine(kw),
            requests, [FAMILY_MAX_NEW] * n, kmods, card)
    try:
        engine(dict(mode="continuous", kv="paged", prefill="stall"))
    except NotImplementedError as e:
        out["paged_refused"] = str(e)
        if refusal not in str(e):
            fail(f"{cfg.name}: kv='paged' refused for another reason: {e}")
    else:
        fail(f"{cfg.name}: kv='paged' was not refused")
    return out


def run_window_model(torch, name: str, layers, kmods, inputs,
                     card: str) -> dict:
    """8b / 8c: WINDOW_REQUESTS prompts left-padded to WINDOW_BUCKET, past
    the model's window, through each of the model's WINDOW_ROWS eager and
    graphed; the paged rows must refuse the window as the reference
    does."""
    cfg, params, info = family_model(torch, name, layers)
    if not cfg.window < WINDOW_BUCKET:
        fail(f"{name}: window {cfg.window} not below the bucket")
    return {"model": info, **contiguous_serves(
        torch, cfg, params, WINDOW_ROWS[name], WINDOW_BUCKET,
        WINDOW_REQUESTS, "fifo", "sliding-window", kmods, inputs, card)}


def run_families(torch, F, kmods, inputs, card: str, serve_kmods) -> dict:
    """Phase 8, one model on the card at a time."""
    out = {"kimi-k2-1t-a32b": run_kimi(torch, F, kmods, inputs, card,
                                       serve_kmods)}
    free_card(torch)
    out["h2o-danube-3-4b"] = run_window_model(
        torch, "h2o-danube-3-4b", None, kmods, inputs, card)
    free_card(torch)
    out["mixtral-8x22b"] = run_window_model(
        torch, "mixtral-8x22b", MIXTRAL_LAYERS, kmods, inputs, card)
    free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phase 9: the recurrent families
# ---------------------------------------------------------------------------

#: 9a: mamba2-1.3b's prompts left-padded to 640 tokens (three SSD chunks of
#: 256, the last padded), 16 slots, RT-LM; 9b: recurrentgemma-9b's to
#: 2304, past its 2048-token local window, 8 slots, FIFO
SSM_BUCKET = 640
HYBRID_BUCKET = 2304
HYBRID_REQUESTS = 8
RECURRENT_ROWS = (
    ("batch", dict(mode="batch", kv="contiguous", prefill="stall")),
    ("contiguous-stall", dict(mode="continuous", kv="contiguous",
                              prefill="stall", decode_steps=DECODE_STEPS)))
#: 9a (i): the float32 chunked scan against the float32 step-by-step
#: recurrence, elementwise within SSD_RTOL * (|naive| + mean |naive|).  The
#: reference's segment sums are cumsum differences: over a 256-token chunk
#: the layer's cumsums of dt * A reach a few hundred, of which float32
#: keeps ~1e-5, so exp(segsum) carries relative errors up to ~1e-4 (the
#: step-by-step product does not); 1e-3 leaves ten times that
SSD_RTOL = 1e-3
#: the reference's refusal of a recurrent family's paged cache
#: (src/repro/models/transformer.py:712-714)
RECURRENT_REFUSAL = ("paged KV cache: family {!r} carries recurrent/cross "
                     "state the paged cache does not cover")


def naive_ssd(torch, x, a, B_, C_):
    """The reference test's step-by-step recurrence (tests/test_ssm.py):
    h_t = exp(a_t) h_{t-1} + x_t (x) B_t, y_t = C_t . h_t, float32 on the
    card, one token a step."""
    b, s, h, p = x.shape
    rep = h // B_.shape[2]
    Bh = B_.float().repeat_interleave(rep, dim=2)
    Ch = C_.float().repeat_interleave(rep, dim=2)
    x, a = x.float(), a.float()
    st = torch.zeros((b, h, p, Bh.shape[-1]), dtype=torch.float32,
                     device=x.device)
    ys = []
    for t in range(s):
        st = (st * torch.exp(a[:, t])[..., None, None]
              + x[:, t, :, :, None] * Bh[:, t, :, None, :])
        ys.append((st * Ch[:, t, :, None, :]).sum(-1))
    return torch.stack(ys, dim=1), st


def check_ssd_layer(torch, cfg, params) -> dict:
    """9a (i): layer 0's ``ssd_chunked`` at full width on the inputs the
    layer gives it for two SSM_BUCKET-token prompts (caught from one
    ``apply_mamba2`` call).  In float32, against the step-by-step float32
    recurrence (the reference's own check, within SSD_RTOL); in bf16 (the
    model's: decay factors and carried states rounded to bf16 as the
    reference rounds them), against the same call on the CPU, where the
    tests hold the port to JAX (``kernels/compare.py``'s rule).  The bf16
    scan's distance from the recurrence is reported, not held: it is the
    reference's bf16 rounding."""
    from repro_torch.kernels.compare import compare
    from repro_torch.models import layers, ssm
    rng = np.random.default_rng(SEED + 9)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (2, SSM_BUCKET)).astype(np.int32)).to("cuda")
    p = params["layers"][0]
    h = layers.rms_norm(layers.embed(params["embed"], tokens, cfg),
                        p["ln"], cfg.norm_eps)
    caught, scan = [], ssm.ssd_chunked
    ssm.ssd_chunked = lambda *a: caught.append(a) or scan(*a)
    try:
        ssm.apply_mamba2(p["mixer"], h, cfg)
    finally:
        ssm.ssd_chunked = scan
    (x, a, B_, C_, chunk, _), = caught
    yn, fn = naive_ssd(torch, x, a, B_, C_)
    y32, fin32 = scan(x.float(), a, B_.float(), C_.float(), chunk)
    y, fin = scan(x, a, B_, C_, chunk)
    yc, finc = scan(*(t.cpu() for t in (x, a, B_, C_)), chunk)
    torch.cuda.synchronize()

    def share(out, ref):
        err = (out.float() - ref).abs()
        return float((err / (SSD_RTOL * (ref.abs() + ref.abs().mean()))
                      ).max())

    def held(pairs):
        return {k: dict(zip(("max_abs_err", "limit_share"),
                            compare(o, r.to(o.device))))
                for k, o, r in pairs}

    out = {"shape": {"b": x.shape[0], "s": x.shape[1], "h": x.shape[2],
                     "p": x.shape[3], "g": B_.shape[2], "n": B_.shape[3],
                     "chunk": chunk, "chunks": -(-x.shape[1] // chunk)},
           "x_dtype": str(x.dtype), "a_min": float(a.min()),
           "y_scale": float(yn.abs().max()),
           "f32_vs_recurrence_share": {"y": share(y32, yn),
                                       "final": share(fin32, fn)},
           "bf16_vs_cpu": held((("y", y, yc), ("final", fin, finc))),
           "bf16_vs_recurrence": held((("y", y, yn), ("final", fin, fn)))}
    if not max(out["f32_vs_recurrence_share"].values()) <= 1.0:
        fail(f"ssd layer: the float32 scan is off the recurrence: {out}")
    if not max(v["limit_share"] for v in out["bf16_vs_cpu"].values()) \
            <= 1.0:
        fail(f"ssd layer: the bf16 scan on the card is off the CPU's: {out}")
    return out


def check_decode_continues_prefill(torch, cfg, params, S: int) -> dict:
    """9a / 9b (ii), 10a / 10b: two prompts of S tokens prefilled (behind
    the stub frontend's patches or frames for a vlm or encdec config),
    then one decode step of token S + 1, against one prefill of all S + 1
    tokens: last logits within LOGIT_ATOL, the same top-1 (phase 3's
    limit)."""
    from repro_torch.models import model as model_lib
    rng = np.random.default_rng(SEED + 10)
    toks = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (2, S + 1)).astype(np.int32)).to("cuda")
    kw = frontend_inputs(torch, cfg, 2)
    max_len = S + 1 + 8 + (cfg.num_patch_tokens
                           if cfg.frontend == "vision" else 0)
    _, want = model_lib.prefill(params, cfg, toks, max_len, **kw)
    cache, _ = model_lib.prefill(params, cfg, toks[:, :S], max_len, **kw)
    _, got = model_lib.decode_step(params, cfg, cache, toks[:, S:])
    # the padded vocabulary's columns are masked to -1e30 in both
    want, got = want[:, :cfg.vocab_size], got[:, :cfg.vocab_size]
    torch.cuda.synchronize()
    out = {"S": S, "logits_max_abs_err": float((got - want).abs().max()),
           "logits_scale": float(want.abs().max()),
           "top1": [got.argmax(-1).tolist(), want.argmax(-1).tolist()]}
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{cfg.name}: non-finite logits")
    if out["logits_max_abs_err"] > LOGIT_ATOL:
        fail(f"{cfg.name}: decode after prefill vs one prefill: {out}")
    if out["top1"][0] != out["top1"][1]:
        fail(f"{cfg.name}: decode after prefill changed the top-1: {out}")
    return out


def run_recurrent(torch, kmods, inputs, card: str) -> dict:
    """Phase 9, one model on the card at a time: 9a mamba2-1.3b whole
    (the SSD layer check, the decode check, its rows at SSM_BUCKET on
    phase 4's 16 slots under RT-LM), 9b recurrentgemma-9b whole (the
    decode check past its window, its rows at HYBRID_BUCKET under
    FIFO)."""
    out = {}
    for name, bucket, n, policy in (
            ("mamba2-1.3b", SSM_BUCKET, NUM_SLOTS, "rt-lm"),
            ("recurrentgemma-9b", HYBRID_BUCKET, HYBRID_REQUESTS, "fifo")):
        cfg, params, info = family_model(torch, name)
        res = {"model": info}
        if cfg.family == "ssm":
            res["ssd_layer"] = check_ssd_layer(torch, cfg, params)
            print(f"ssd layer {name} [{card}]: "
                  f"{json.dumps(res['ssd_layer'])}", flush=True)
        elif not cfg.local_window < bucket:
            fail(f"{name}: local window {cfg.local_window} not below the "
                 "bucket")
        res["decode_check"] = check_decode_continues_prefill(
            torch, cfg, params, bucket)
        print(f"decode check {name} [{card}]: "
              f"{json.dumps(res['decode_check'])}",
              flush=True)
        res.update(contiguous_serves(
            torch, cfg, params, RECURRENT_ROWS, bucket, n, policy,
            RECURRENT_REFUSAL.format(cfg.family), kmods, inputs, card))
        out[name] = res
        del params
        free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phase 10: the multimodal and encoder-decoder families
# ---------------------------------------------------------------------------

#: 10a / 10b: MM_ROWS corpus prompts of MM_PROMPT tokens behind the stub
#: frontend (llava's 2880 patches, seamless's 4096 frames), MM_NEW tokens
#: generated
MM_ROWS = 4
MM_PROMPT = 64
MM_NEW = 32


def frontend_inputs(torch, cfg, rows: int) -> dict:
    """Seeded stub patches (vision frontend) or frames (encdec) for
    ``rows`` prompts, bf16 on the card; {} for the other families."""
    from repro_torch.models import multimodal
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    if cfg.frontend == "vision":
        return {"patches": multimodal.stub_patch_embeddings(gen, rows, cfg)}
    if cfg.family == "encdec":
        return {"frames": multimodal.stub_frame_embeddings(gen, rows, cfg)}
    return {}


def check_float32_copy(torch, cfg, params, tokens, kw: dict) -> dict:
    """Step 0's logits (the prefill's, at the last prompt token) of the
    bf16 model against a float32 copy of the same weights on the card,
    the same stub inputs: within LOGIT_ATOL, the same top-1.  Also the
    bf16 prefill's wall time (the second call: the first warms up)."""
    from repro_torch.models import model as model_lib
    from repro_torch.tree import tree_map
    V = cfg.vocab_size
    max_len = tokens.shape[1] + 8 + (cfg.num_patch_tokens
                                     if cfg.frontend == "vision" else 0)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, got = model_lib.prefill(params, cfg, tokens, max_len, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        del cache
    p32 = tree_map(lambda p: p.float(), params)
    _, want = model_lib.prefill(p32, cfg, tokens, max_len,
                                cache_dtype=torch.float32, **kw)
    del p32
    got, want = got[:, :V], want[:, :V]
    torch.cuda.synchronize()
    out = {"prefill_wall_s": walls,
           "logits_max_abs_err": float((got - want).abs().max()),
           "logits_scale": float(want.abs().max()),
           "top1": [got.argmax(-1).tolist(), want.argmax(-1).tolist()]}
    free_card(torch)
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{cfg.name}: non-finite step-0 logits")
    if out["logits_max_abs_err"] > LOGIT_ATOL:
        fail(f"{cfg.name}: bf16 step 0 vs its float32 copy: {out}")
    if out["top1"][0] != out["top1"][1]:
        fail(f"{cfg.name}: bf16 step 0 changed the float32 copy's top-1: "
             f"{out}")
    return out


#: 10a / 10b: eager decode steps under the profiler, and the kernels
#: listed by device time
PROFILE_DECODE_STEPS = 4
PROFILE_TOP = 6


def profile_decode(torch, cfg, params, tokens, kw: dict) -> dict:
    """10a / 10b: PROFILE_DECODE_STEPS eager decode steps after a prefill
    of ``tokens`` behind the stub frontend, each step's token read back
    as ``generate`` reads its stop test, under ``profile_window``: wall,
    device busy and idle share of the window, the device kernels it ran
    and the costliest."""
    from repro_torch.models import model as model_lib
    max_len = tokens.shape[1] + 2 * PROFILE_DECODE_STEPS + 8 + (
        cfg.num_patch_tokens if cfg.frontend == "vision" else 0)
    cache, logits = model_lib.prefill(params, cfg, tokens, max_len, **kw)
    token = [torch.argmax(logits, -1).to(torch.int32)[:, None]]

    def steps():
        for _ in range(PROFILE_DECODE_STEPS):
            token[0], _ = model_lib.decode_step(params, cfg, cache, token[0])
            bool((token[0] < 0).any())

    prof = profile_window(torch, steps, top=PROFILE_TOP)
    del cache, logits, token
    free_card(torch)
    keep = ("wall_s", "device_busy_s", "device_idle_share",
            "device_kernels", "top_kernels")
    return {"steps": PROFILE_DECODE_STEPS,
            **{k: prof[k] for k in keep if k in prof}}


def run_multimodal(torch, inputs, card: str) -> dict:
    """Phase 10, one model on the card at a time: 10a llava-next-mistral-7b
    whole, 10b seamless-m4t-large-v2 whole, each generating MM_NEW tokens
    for MM_ROWS prompts behind its stub frontend (``generate.generate``),
    with the float32-copy and decode checks and a profiled window of
    decode steps."""
    from repro_torch.serving import generate
    from repro_torch.serving.engine import tokenize_padded
    out = {}
    for name in ("llava-next-mistral-7b", "seamless-m4t-large-v2"):
        torch.cuda.reset_peak_memory_stats()
        cfg, params, info = family_model(torch, name)
        tokens = torch.from_numpy(np.stack([
            tokenize_padded(t.text, cfg.vocab_size, MM_PROMPT)
            for t in inputs["test"][:MM_ROWS]])).to("cuda")
        kw = frontend_inputs(torch, cfg, MM_ROWS)
        front = next(iter(kw.values()))
        res = {"model": info, "rows": MM_ROWS, "prompt_tokens": MM_PROMPT,
               "frontend": {k: list(v.shape) for k, v in kw.items()}}
        res["float32_check"] = check_float32_copy(torch, cfg, params,
                                                  tokens, kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lengths = generate.generate(params, cfg, tokens,
                                          max_new_tokens=MM_NEW, eos_id=-1,
                                          **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        toks = toks.cpu()
        res["generate"] = {
            "wall_s": wall, "new_tokens": MM_NEW,
            "positions": front.shape[1] + MM_PROMPT
            if cfg.frontend == "vision" else MM_PROMPT,
            "generated_tokens_per_s": MM_ROWS * MM_NEW / wall,
            "tokens": toks.tolist(), "lengths": lengths.tolist()}
        if toks.shape != (MM_ROWS, MM_NEW) or \
                lengths.tolist() != [MM_NEW] * MM_ROWS:
            fail(f"{name}: generate gave {tuple(toks.shape)} tokens, "
                 f"lengths {lengths.tolist()}")
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{name}: generated a token outside the vocabulary")
        res["decode_profile"] = profile_decode(torch, cfg, params, tokens,
                                               kw)
        res["decode_check"] = check_decode_continues_prefill(
            torch, cfg, params, MM_PROMPT)
        res["memory_allocated_peak_bytes"] = torch.cuda.max_memory_allocated()
        line = {k: res[k] for k in ("rows", "prompt_tokens", "frontend",
                                    "float32_check", "decode_profile",
                                    "decode_check")}
        line["generate"] = {k: v for k, v in res["generate"].items()
                            if k != "tokens"}
        print(f"multimodal {name} [{card}]: {json.dumps(line)}", flush=True)
        out[name] = res
        del params, kw, front
        free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phase 11: training and the launchers
# ---------------------------------------------------------------------------

#: 11a / 11b: ``launch.train`` arguments at full width (``--no-smoke``:
#: every layer rematerialised)
TRAIN_RUNS = {
    "starcoder2-3b": ["--optimizer", "adamw", "--lr", "3e-4", "--batch", "4",
                      "--seq", "1024", "--steps", "20", "--log-every", "5"],
    "mamba2-1.3b": ["--optimizer", "adafactor", "--lr", "1e-3", "--batch",
                    "4", "--seq", "1024", "--steps", "10", "--log-every",
                    "5"],
}
#: 11a's first-step check: bf16 loss against a float32 copy's (absolute)
#: and the global gradient norm (relative).  bf16 reads 3.0e-4 and 3.0e-4
#: on the H100; skipping one of the 30 layers (the planted fault) 9.0e-3
#: and 3.2e-3, so these limits must, and do, catch it
FIRST_LOSS_ATOL = 3e-3
FIRST_NORM_RTOL = 2e-3
SERVE_REQUESTS = 16


def first_batch(torch, cfg, batch: int, seq: int) -> dict:
    """The launcher's first batch (``SyntheticLMData`` seed 0, stub 0)."""
    from repro_torch.training import data as data_lib
    pipe = data_lib.SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                                    batch_size=batch, seed=SEED)
    return data_lib.add_modality_stub(
        next(pipe.batches(1, device="cuda")), cfg, seed=0)


def float32_first_step(torch, cfg, batch: dict) -> dict:
    """11a: the loss and global gradient norm of a float32 copy of the
    launcher's weights (``init_params`` seed SEED, the launcher's
    ``--seed``) on its first batch, rematerialised as the launcher runs
    them; and, as a planted fault that ``check_first_step`` reads against
    its limits, the same with the middle layer skipped."""
    from repro_torch.models import model as model_lib
    from repro_torch.training.optimizer import global_norm
    from repro_torch.tree import tree_map, tree_paths
    params = tree_map(lambda t: t.float(), model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda"))
    skip = cfg.num_layers // 2
    out = {}
    for label, p in (("float32", params),
                     ("planted_fault", dict(params, layers=[
                         layer for i, layer in enumerate(params["layers"])
                         if i != skip]))):
        leaves = [t.requires_grad_(True) for _, t in tree_paths(p)]
        loss, _ = model_lib.lm_loss(p, cfg, batch, remat=True)
        grads = torch.autograd.grad(loss, leaves)
        out[label] = {"loss": float(loss.detach()),
                      "grad_norm": float(global_norm(grads))}
        del grads, loss, leaves, p
        free_card(torch)
    out["planted_fault"]["skipped_layer"] = skip
    del params
    free_card(torch)
    return out


def first_step_errors(got: dict, want: dict) -> dict:
    return {"loss_abs_err": abs(got["loss"] - want["loss"]),
            "grad_norm_rel_err": abs(got["grad_norm"] - want["grad_norm"])
            / want["grad_norm"]}


def check_first_step(cfg, first: dict, f32: dict) -> dict:
    """11a: the launcher's own first step (``metrics[0]``: bf16 weights,
    remat) against ``float32_first_step``'s copy: loss within
    FIRST_LOSS_ATOL, global gradient norm within FIRST_NORM_RTOL; and
    the planted fault must miss at least one of those limits."""
    bf16 = {k: first[k] for k in ("loss", "grad_norm")}
    out = {"bf16": bf16, **f32, **first_step_errors(bf16, f32["float32"])}
    fault = first_step_errors(f32["planted_fault"], f32["float32"])
    fault["over_limits"] = [fault["loss_abs_err"] > FIRST_LOSS_ATOL,
                            fault["grad_norm_rel_err"] > FIRST_NORM_RTOL]
    out["planted_fault"].update(fault)
    if not all(np.isfinite([bf16["loss"], f32["float32"]["loss"],
                            bf16["grad_norm"],
                            f32["float32"]["grad_norm"]])):
        fail(f"{cfg.name}: non-finite first step: {out}")
    if out["loss_abs_err"] > FIRST_LOSS_ATOL:
        fail(f"{cfg.name}: bf16 loss vs float32 copy: {out}")
    if out["grad_norm_rel_err"] > FIRST_NORM_RTOL:
        fail(f"{cfg.name}: bf16 gradient norm vs float32 copy: {out}")
    if not any(fault["over_limits"]):
        fail(f"{cfg.name}: the first-step check passes a skipped layer: "
             f"{out}")
    return out


def run_train(torch, name: str, card: str) -> dict:
    """11a / 11b: ``launch.train.main`` at full width with TRAIN_RUNS's
    arguments; the losses and gradient norms must be finite and the mean
    of the last five losses below the first.  11a also holds the
    launcher's first step to a float32 copy of its weights
    (``check_first_step``), and writes a checkpoint whose restored
    parameters must give the trained parameters' eval loss bit for bit."""
    import shutil
    from repro_torch import configs
    from repro_torch.launch import train as train_launch
    from repro_torch.training import checkpoint as ckpt_lib
    from repro_torch.training import train_step as ts_lib
    from repro_torch.tree import tree_paths
    cfg = configs.get_config(name)
    argv = TRAIN_RUNS[name] + ["--seed", str(SEED)]
    B, S = int(argv[argv.index("--batch") + 1]), \
        int(argv[argv.index("--seq") + 1])
    out = {"args": argv}
    ckpt = f32 = None
    if name == "starcoder2-3b":
        f32 = float32_first_step(torch, cfg, first_batch(torch, cfg, B, S))
        ckpt = ROOT / "build" / "train_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = argv + ["--checkpoint", str(ckpt)]
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    t0 = time.perf_counter()
    rc = train_launch.main(["--arch", name, "--no-smoke", "--device", "cuda",
                            *argv], out=rec)
    out["wall_s"] = time.perf_counter() - t0
    out["memory_allocated_peak_bytes"] = torch.cuda.max_memory_allocated()
    hist = rec["metrics"]
    losses = [m["loss"] for m in hist]
    norms = [m["grad_norm"] for m in hist]
    out.update(rc=rc, losses=losses, grad_norms=norms,
               step_s=rec["step_s"],
               step_s_median=statistics.median(rec["step_s"][1:]),
               first_loss=losses[0],
               last5_mean_loss=statistics.fmean(losses[-5:]))
    if rc != 0 or len(losses) != int(argv[argv.index("--steps") + 1]):
        fail(f"{name}: the launcher returned {rc} after {len(losses)} steps")
    if f32 is not None:
        out["first_step"] = check_first_step(cfg, hist[0], f32)
        print(f"train first step {name} [{card}]: "
              f"{json.dumps(out['first_step'])}", flush=True)
    if not all(np.isfinite(losses + norms)):
        fail(f"{name}: non-finite loss or gradient norm: {out}")
    if not out["last5_mean_loss"] < losses[0]:
        fail(f"{name}: the loss did not fall: {out}")
    if ckpt is not None:
        ev = ts_lib.make_eval_step(cfg)
        batch = first_batch(torch, cfg, B, S)
        trained = float(ev(rec["params"], batch)["loss"])
        restored, step = ckpt_lib.restore(str(ckpt),
                                          like={"params": rec["params"]})
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_paths(rec["params"]), tree_paths(restored["params"])))
        back = float(ev(restored["params"], batch)["loss"])
        out["checkpoint"] = {"step": step, "eval_loss": trained,
                             "restored_eval_loss": back,
                             "leaves_equal": same,
                             "bytes": sum(f.stat().st_size
                                          for f in ckpt.iterdir())}
        del restored
        shutil.rmtree(ckpt, ignore_errors=True)
        if step != len(losses) or not same or back != trained:
            fail(f"{name}: the restored checkpoint differs: "
                 f"{out['checkpoint']}")
    del rec
    free_card(torch)
    line = {k: v for k, v in out.items() if k not in ("step_s",)}
    print(f"train {name} [{card}]: {json.dumps(line)}", flush=True)
    return out


def run_serve_launcher(torch, card: str) -> dict:
    """11c: ``launch.serve.main`` on the card at its smoke size with
    SERVE_REQUESTS requests; its JSON result must account for every
    request."""
    import io
    from repro_torch.launch import serve as serve_launch
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_launch.main(["--arch", "starcoder2-3b", "--n-requests",
                                str(SERVE_REQUESTS), "--device", "cuda"])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    res = json.loads(text[text.index("\n{") + 1:])
    out = {"rc": rc, "wall_s": wall, "n_tasks": res.get("n_tasks"),
           "completed": len(res.get("completion_order", [])),
           "device": res.get("device"),
           "mean_response_time_s": res.get("mean_response_time"),
           "scheduler_overhead_ms_per_task":
               res.get("scheduler_overhead_ms_per_task")}
    if rc != 0 or out["n_tasks"] != SERVE_REQUESTS or \
            out["completed"] != SERVE_REQUESTS or out["device"] != "cuda":
        fail(f"serve launcher: {out}")
    print(f"serve launcher [{card}]: {json.dumps(out)}", flush=True)
    return out


def run_training(torch, card: str) -> dict:
    """Phase 11: 11a starcoder2-3b and 11b mamba2-1.3b through
    ``launch.train``, one model on the card at a time, then 11c
    ``launch.serve``."""
    out = {name: run_train(torch, name, card) for name in TRAIN_RUNS}
    out["serve"] = run_serve_launcher(torch, card)
    free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phase 12: the sharding layer on NCCL ranks
# ---------------------------------------------------------------------------

#: 12a: phase 11a's run on the mesh, cut to 3 steps
SHARD_TRAIN = ["--optimizer", "adamw", "--lr", "3e-4", "--batch", "4",
               "--seq", "1024", "--steps", "3", "--log-every", "1"]
SHARD_MOE_TOKENS = (4, 256)      # 12b: B, S into mixtral's MoE layer
SHARD_PROMPT = (4, 256)          # 12c: B, S of the prompts
SHARD_DECODE = 4                 # 12c: decode steps after the prefill


def run_sharded(torch, first_step: dict, card: str) -> dict:
    """Phase 12: one NCCL rank a visible card (``torch.cuda.device_count()``)
    on the mesh (1, world) ("data", "model"), started with
    ``torch.multiprocessing.spawn``; a failed rank fails the script.  The
    ranks run 12a-12c (``sharded_rank``); rank 0 writes the results to
    ``build/phase12.json``, which this process reads and prints."""
    import socket
    import torch.multiprocessing as mp
    free_card(torch)
    world = torch.cuda.device_count()
    path = ROOT / "build" / "phase12.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    f32 = {"float32": first_step["float32"],
           "planted_fault": {k: first_step["planted_fault"][k]
                             for k in ("loss", "grad_norm", "skipped_layer")}}
    t0 = time.perf_counter()
    mp.spawn(sharded_rank, args=(world, port, f32, str(path), card),
             nprocs=world, join=True)
    out = json.loads(path.read_text())
    out["wall_s"] = time.perf_counter() - t0
    print(f"sharded [{card}]: world {world}, mesh {out['mesh']}, "
          f"{out['wall_s']:.1f} s with the ranks' start", flush=True)
    return out


def sharded_rank(rank: int, world: int, port: int, f32: dict, path: str,
                 card: str) -> None:
    """One rank of phase 12: its card, the NCCL process group, the mesh
    (1, world); then 12a ``sharded_train``, 12b ``sharded_moe`` and 12c
    ``sharded_serve``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank))
    try:
        from repro_torch.launch import mesh as mesh_lib
        mesh = mesh_lib.make_mesh((1, world), ("data", "model"), "cuda")
        lead = rank == 0
        out = {"world": world, "mesh": dict(zip(mesh.mesh_dim_names,
                                                 tuple(mesh.shape)))}
        if lead:
            print(f"sharded: world {world}, mesh {out['mesh']}, NCCL "
                  f"{'.'.join(map(str, torch.cuda.nccl.version()))}",
                  flush=True)
        out["train"] = sharded_train(torch, f"1x{world}", f32, card, lead)
        out["moe"] = sharded_moe(torch, mesh, card, lead)
        out["serve"] = sharded_serve(torch, mesh, card, lead)
        if lead:
            Path(path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def sharded_train(torch, mesh_arg: str, f32: dict, card: str,
                  lead: bool) -> dict:
    """12a: ``launch.train.main --mesh 1x<world> --no-smoke`` on
    starcoder2-3b at phase 11a's batch (B 4, S 1024, AdamW) for 3 steps;
    its first step (bf16, remat) held to phase 11's float32 copy of the
    same weights and batch under phase 11's limits (``check_first_step``);
    every loss and norm finite.  Seconds a step and peak
    ``memory_allocated``."""
    from repro_torch import configs
    from repro_torch.launch import train as train_launch
    cfg = configs.get_config("starcoder2-3b")
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    t0 = time.perf_counter()
    rc = train_launch.main(["--arch", "starcoder2-3b", "--no-smoke",
                            "--device", "cuda", "--mesh", mesh_arg,
                            *SHARD_TRAIN, "--seed", str(SEED)], out=rec)
    hist = rec["metrics"]
    out = {"rc": rc, "wall_s": time.perf_counter() - t0,
           "memory_allocated_peak_bytes": torch.cuda.max_memory_allocated(),
           "losses": [m["loss"] for m in hist],
           "grad_norms": [m["grad_norm"] for m in hist],
           "step_s": rec["step_s"],
           "step_s_median": statistics.median(rec["step_s"][1:]),
           "param_placements": sorted({str(p.placements) for p in
                                       _leaves(rec["params"])})}
    if rc != 0 or len(hist) != int(SHARD_TRAIN[SHARD_TRAIN.index(
            "--steps") + 1]):
        fail(f"sharded train: the launcher returned {rc}")
    out["first_step"] = check_first_step(cfg, hist[0], f32)
    if not all(np.isfinite(out["losses"] + out["grad_norms"])):
        fail(f"sharded train: non-finite loss or gradient norm: {out}")
    del rec
    free_card(torch)
    if lead:
        print(f"sharded train {cfg.name} [{card}]: {json.dumps(out)}",
              flush=True)
    return out


def sharded_moe(torch, mesh, card: str, lead: bool) -> dict:
    """12b: mixtral-8x22b's MoE layer alone at full width (8 experts of
    d_ff 16384 over d_model 6144, bf16), SHARD_MOE_TOKENS tokens, through
    ``apply_moe_ep`` under the serving layout (``make_policy(mesh,
    fsdp=False)``, ``serving=True``: the token-replicated path) and the
    train layout (``make_policy(mesh)``); each output held to
    ``apply_moe_local`` on the same inputs by ``kernels/compare.py``'s
    rule, the aux loss and drop fraction printed beside the local ones."""
    from repro_torch import configs
    from repro_torch.kernels.compare import compare
    from repro_torch.models import moe
    from repro_torch.sharding import context as shctx, policy as policy_lib
    cfg = configs.get_config("mixtral-8x22b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    params = moe.init_moe(gen, cfg, torch.bfloat16, "cuda")
    B, S = SHARD_MOE_TOKENS
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.float32).to(torch.bfloat16)
    with torch.no_grad():
        want, aux_want = moe.apply_moe_local(params, x, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe.apply_moe_local(params, x, cfg)
        torch.cuda.synchronize()
        local_ms = 1e3 * (time.perf_counter() - t0)
    out = {"tokens": [B, S], "weight_bytes": sum(
        t.numel() * t.element_size() for t in _leaves(params)),
        "local_ms": local_ms}
    for layout in ("serving", "train"):
        policy = (dataclasses.replace(
            policy_lib.make_policy(mesh, fsdp=False), serving=True)
            if layout == "serving" else policy_lib.make_policy(mesh))
        dp = policy.distribute({"moe": params}, policy.param_shardings(
            {"moe": params}))["moe"]
        with torch.no_grad(), shctx.use_policy(policy):
            dx = policy.distribute_one(x, policy.spec(
                x.shape, ("batch", None, None)))
            got, aux = moe.apply_moe(dp, dx, cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moe.apply_moe(dp, dx, cfg)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        err, share = compare(got.full_tensor(), want)
        out[layout] = {
            "ms": ms, "max_abs_err": err, "limit_share": share,
            "token_replicated": layout == "serving"
            and B * S * cfg.experts_per_token <= 32768,
            "moe_aux_loss": float(aux["moe_aux_loss"].full_tensor()),
            "moe_aux_loss_local": float(aux_want["moe_aux_loss"]),
            "moe_drop_frac": float(aux["moe_drop_frac"].full_tensor()),
            "moe_drop_frac_local": float(aux_want["moe_drop_frac"])}
        if share > 1.0:
            fail(f"sharded moe ({layout}): apply_moe_ep vs apply_moe_local: "
                 f"{out[layout]}")
        del dp, got
    del params, want
    free_card(torch)
    if lead:
        print(f"sharded moe {cfg.name} [{card}]: {json.dumps(out)}",
              flush=True)
    return out


def sharded_serve(torch, mesh, card: str, lead: bool) -> dict:
    """12c: full-width starcoder2-3b ``prefill`` of SHARD_PROMPT prompts
    and SHARD_DECODE ``decode_step``s under the serving layout
    (``make_policy(mesh, fsdp=False)``, ``serving=True``), both runs fed
    the unsharded run's greedy tokens; every step's logits within
    LOGIT_ATOL of the unsharded run's with the same top-1."""
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import context as shctx, policy as policy_lib
    cfg = configs.get_config("starcoder2-3b")
    params = model_lib.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    B, S = SHARD_PROMPT
    rng = np.random.default_rng(SEED + 12)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, size=(B, S)).astype(np.int32)).to("cuda")
    max_len = S + SHARD_DECODE

    def run(p, toks, full, feed):
        """Logits and seconds of the prefill and each decode step; with
        ``feed`` empty the steps take their own greedy tokens into it."""
        greedy = not feed
        times, logits = [], []
        t0 = time.perf_counter()
        cache, last = model_lib.prefill(p, cfg, toks, max_len)
        logits.append(full(last))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        for i in range(SHARD_DECODE):
            if greedy:
                feed.append(torch.argmax(logits[-1], -1).to(
                    torch.int32)[:, None])
            t0 = time.perf_counter()
            logits.append(full(model_lib.decode_step(p, cfg, cache,
                                                     feed[i])[1]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return logits, times

    feed = []
    run(params, tokens, lambda t: t, feed)          # warm, and the tokens
    want, want_s = run(params, tokens, lambda t: t, feed)
    policy = dataclasses.replace(policy_lib.make_policy(mesh, fsdp=False),
                                 serving=True)
    dp = policy.distribute(params, policy.param_shardings(params))
    with shctx.use_policy(policy):
        dtok = policy.distribute_one(tokens, policy.spec(tokens.shape,
                                                         ("batch", None)))
        got, got_s = run(dp, dtok, lambda t: t.full_tensor(), feed)
        first_s = got_s
        got, got_s = run(dp, dtok, lambda t: t.full_tensor(), feed)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    top1 = [float((g.argmax(-1) == w.argmax(-1)).float().mean())
            for g, w in zip(got, want)]
    out = {"prompts": [B, S], "decode_steps": SHARD_DECODE,
           "logits_max_abs_err": errs, "top1_agree": top1,
           "logits_scale": float(want[0].abs().max()),
           "prefill_s": got_s[0], "prefill_s_unsharded": want_s[0],
           "first_run_s": sum(first_s),
           "decode_s": got_s[1:], "decode_s_unsharded": want_s[1:]}
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"sharded serve: non-finite logits: {out}")
    if max(errs) > LOGIT_ATOL or min(top1) < 1.0:
        fail(f"sharded serve: sharded vs unsharded logits: {out}")
    del params, dp
    free_card(torch)
    if lead:
        print(f"sharded serve {cfg.name} [{card}]: {json.dumps(out)}",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the dry run and the simulator
# ---------------------------------------------------------------------------

#: 13a: phase 11a's step (starcoder2-3b whole, B 4, S 1024, AdamW, remat)
DRY_BATCH, DRY_SEQ = 4, 1024
DRY_COUNT_RTOL = 0.01            # fake vs real flops and HBM bytes
DRY_MEMORY_RATIO = (0.8, 1.25)   # predicted resident / real peak
DRY_STEPS = 3                    # real steps timed after the counted one
#: 13b: the production-mesh dry run, in a subprocess on the host; the
#: train step is the smallest whose layout moves shards by all-to-all
DRY_CLI = ["--arch", "mamba2-1.3b", "--shape", "decode_32k"]
DRY_CLI_A2A = ["--arch", "starcoder2-3b", "--shape", "train_4k"]
DRY_CLI_TIMEOUT_S = 300


def check_dry_run(torch, card: str) -> dict:
    """13a: the dry run's shape-only train step against the same step on
    the card, both on a (1, 1) mesh of a fake world of one under the
    reference's policy (FSDP on, which a mesh of one leaves replicated).
    The fake step's counts (``op_cost``), predicted resident bytes
    (``MemTracker``) and roofline come from ``dryrun.dry_step``; the real
    step runs once inside ``op_cost`` (its peak ``memory_allocated``
    kept), then DRY_STEPS times outside it for the seconds a step."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import dryrun, mesh as mesh_lib, op_cost, specs
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import context as shctx, policy as policy_lib
    cfg = configs.get_config("starcoder2-3b")
    shape = configs.InputShape("phase11a", DRY_SEQ, DRY_BATCH, "train")
    free_card(torch)
    dryrun.ensure_world(1)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
        policy = policy_lib.make_policy(mesh)
        t0 = time.perf_counter()
        fake, mem, roof, _, _ = dryrun.dry_step(cfg, shape, policy, "cuda")
        fake_s = time.perf_counter() - t0
        params = model_lib.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
        opt_state = specs.step_optimizer(cfg).init(params)
        args = (params, opt_state, first_batch(torch, cfg, DRY_BATCH,
                                               DRY_SEQ))
        in_specs = specs.step_shardings(cfg, shape, policy, args)
        args = dryrun.lay_out(policy, shape, args, in_specs)
        step = specs.make_step_fn(cfg, shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with shctx.use_policy(policy):
            with op_cost.OpCost() as real:
                step(*args)
            torch.cuda.synchronize()
            times = []
            for _ in range(DRY_STEPS):
                t0 = time.perf_counter()
                step(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        del args, params, opt_state
    finally:
        dist.destroy_process_group()
    free_card(torch)
    resident = mem["resident_bytes_per_device"]
    out = {"model": cfg.name, "batch": DRY_BATCH, "seq": DRY_SEQ,
           "mesh": [1, 1], "fake_step_s": fake_s,
           "fake": {"flops": fake.flops, "hbm_bytes": fake.traffic_bytes,
                    "resident_bytes": resident, "memory": mem},
           "real": {"flops": real.cost.flops,
                    "hbm_bytes": real.cost.traffic_bytes,
                    "memory_allocated_peak_bytes": peak},
           "flops_rel_err": abs(fake.flops / real.cost.flops - 1),
           "hbm_bytes_rel_err": abs(fake.traffic_bytes
                                    / real.cost.traffic_bytes - 1),
           "memory_ratio": resident / peak,
           "roofline": roof.to_dict(), "bound_s": roof.bound_s,
           "step_s": times, "step_s_median": statistics.median(times)}
    out["step_over_bound"] = out["step_s_median"] / roof.bound_s
    print(f"dry run 13a {cfg.name} [{card}]: {json.dumps(out)}", flush=True)
    if max(out["flops_rel_err"], out["hbm_bytes_rel_err"]) > DRY_COUNT_RTOL:
        fail(f"dry run 13a: fake and real counts differ: {out}")
    lo, hi = DRY_MEMORY_RATIO
    if not lo <= out["memory_ratio"] <= hi:
        fail(f"dry run 13a: predicted resident bytes {resident} against "
             f"a real peak of {peak}")
    return out


def run_dry_run_cli(card: str, args, all_to_all: bool = False) -> dict:
    """13b: the production-mesh dry run as a user runs it, in a
    subprocess on the host (no card: fake tensors on a fake world of
    256); it must end ``ok`` with flops and resident bytes above 0, and
    with ``all_to_all`` count at least one all-to-all (DTensor's
    Shard -> Shard as a CUDA mesh moves it, not gloo's all-gather)."""
    import os
    path = ROOT / "build" / f"dryrun_13b_{args[1]}.{args[3]}.json"
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(path)], capture_output=True, text=True, env=env,
        cwd=str(ROOT), timeout=DRY_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not path.exists():
        fail(f"dry run 13b: exit {proc.returncode}: {proc.stderr[-2000:]}")
    res = json.loads(path.read_text())
    roof, mem, coll = res["roofline"], res["memory"], res["collectives"]
    if res["status"] != "ok" or roof["flops_per_dev"] <= 0 or \
            mem["resident_bytes_per_device"] <= 0 or \
            (all_to_all and coll["counts"]["all-to-all"] < 1):
        fail(f"dry run 13b: {json.dumps(res)}")
    for line in proc.stdout.splitlines():
        if line.lstrip().startswith(("[dryrun]", "resident/device",
                                     "roofline", "collectives")):
            print(f"dry run 13b: {line.strip()}", flush=True)
    out = {"args": args, "wall_s": wall, "mesh": res["mesh"],
           "roofline": roof, "memory": mem, "collectives": coll}
    print(f"dry run 13b [{card}, host only]: {' '.join(args)}: wall "
          f"{wall:.1f} s, "
          f"{json.dumps({k: roof[k] for k in ('compute_s', 'memory_s', 'collective_s', 'dominant')})}",
          flush=True)
    return out


def check_simulator(inputs, eager: dict) -> dict:
    """13c: the port's ``simulate_continuous`` on phase 4's tasks (the
    engine's own ``u`` and priority points, the realised lengths) under
    the engine's policy and settings: every field of SCHEDULE_FIELDS the
    simulator reports equal to phase 4's eager serve."""
    import types
    from repro_torch.core import priority as prio
    from repro_torch.core import scheduler as sched, simulator
    si = eager["sim_inputs"]
    tasks = [prio.SimTask(task=types.SimpleNamespace(task_id=i,
                                                     traffic_class=""),
                          u=u, r=r, d=d, input_len=n, true_out_len=n_out)
             for i, u, r, d, n, n_out in si["tasks"]]
    policy = sched.POLICIES["rt-lm"](inputs["persona"],
                                     inputs["profile"].policy_config())
    t0 = time.perf_counter()
    sim = simulator.simulate_continuous(tasks, policy, **si["settings"])
    sim_s = time.perf_counter() - t0
    got = {"completion_order": [t.task.task_id for t in sim.tasks],
           "rejected_for_memory": sim.kv_rejected,
           **{f: getattr(sim, f) for f in SCHEDULE_FIELDS
              if f not in ("completion_order", "rejected_for_memory")}}
    differ = [f for f in SCHEDULE_FIELDS if got[f] != eager[f]]
    out = {"tasks": len(tasks), "fields": list(SCHEDULE_FIELDS),
           "differ": differ, "sim_s": sim_s,
           "iterations": len(sim.budget_trace),
           "offloaded": sum(t.lane == "cpu" for t in sim.tasks)}
    print(f"simulator 13c: {json.dumps(out)}", flush=True)
    if differ:
        fail(f"simulator 13c: fields {differ} differ from phase 4's eager "
             f"serve: {json.dumps({f: [got[f], eager[f]] for f in differ})}")
    return out


def run_phase13(torch, inputs, eager: dict, card: str) -> dict:
    t0 = time.perf_counter()
    out = {"train_step": check_dry_run(torch, card),
           "cli": [run_dry_run_cli(card, DRY_CLI),
                   run_dry_run_cli(card, DRY_CLI_A2A, all_to_all=True)],
           "simulator": check_simulator(inputs, eager)}
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 13: {out['wall_s']:.1f} s", flush=True)
    return out


#: per-request and per-iteration lists, kept out of the printed lines (the
#: whole record goes to build/chip_smoke.json)
LONG_FIELDS = ("tokens", "completion_order", "budget_trace",
               "prefill_dispatch_trace", "decode_dispatch_trace",
               "sim_inputs")


def printable(row: dict) -> dict:
    return {k: v for k, v in row.items() if k not in LONG_FIELDS}


def save_record(record: dict) -> None:
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record))


def main() -> int:
    started = time.perf_counter()
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
    from repro_torch.kernels import rms_norm as rms_mod
    from repro_torch.kernels import rope_kv as rope_mod
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
    for name, lines in ptxas_report([m.NAME for m in KERNELS]).items():
        for ln in lines:
            print(f"ptxas {name}: {ln}", flush=True)

    # -- phase 2: kernels vs plain versions, then the ops path
    checks = {}
    for m, check in zip(KERNELS, (check_decode, check_ragged,
                                  check_chunked_prefill, check_rms_norm,
                                  check_flash_attention, check_flash_decode,
                                  check_rope_kv)):
        checks[m.NAME] = check(torch, F, m)
        shown = {k: v for k, v in checks[m.NAME].items() if k != "ops"}
        print(f"kernel {m.NAME}: {json.dumps(shown)}", flush=True)
    # rope_kv has no op in the kernel API (the reference runs plain jnp)
    ops_launches = run_ops_path(
        torch, [m for m in KERNELS if checks[m.NAME]["ops"]],
        [c for r in checks.values() for c in r["ops"]])
    print(f"ops path: launches {json.dumps(ops_launches)}", flush=True)

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
    sres = check_single_chunk(torch, cfg, params, KERNELS)
    print(f"single-chunk path: {json.dumps(sres)}", flush=True)

    # -- phase 4: engine
    # the engine's main path runs the decode and fused prefill kernels
    # and the fused pointwise ones (RMSNorm with and without the residual
    # add, RoPE + K/V write), all counted in its serves
    inputs = serving_inputs()
    engine_kmods = KERNELS[:2] + (rms_mod, rope_mod)
    eres = run_engine(torch, cfg, params, engine_kmods, inputs)
    record = {"card": card, "engine": eres}
    save_record(record)
    for mode in ("eager", "graphed"):
        print(f"engine {mode} [{card}]: "
              f"{json.dumps(printable(eres[mode]))}", flush=True)

    # -- phase 5: the engine's other rows
    rres = run_engine_rows(torch, cfg, params, KERNELS[:2], inputs, card)
    record["engine_rows"] = rres
    save_record(record)
    print(f"engine rows [{card}]: token identity "
          f"{json.dumps(rres['token_identity'])}", flush=True)

    # -- phase 6: observability, every row traced
    record["obs"] = run_obs(torch, cfg, params, KERNELS[:2], inputs, eres,
                            rres, card)
    save_record(record)

    # -- phase 7: replicas and faults
    record["pool"] = run_pool(torch, cfg, params, KERNELS[:2], inputs, card)
    save_record(record)

    # -- phase 8: the MoE and sliding-window families, each alone on the
    # card (phases 1-7's starcoder2-3b weights and pools freed first)
    del params
    free_card(torch)
    print(f"phase 8: {torch.cuda.memory_allocated()} bytes still allocated",
          flush=True)
    fres = run_families(torch, F, KERNELS[:2], inputs, card, engine_kmods)
    record["families"] = fres
    save_record(record)

    # -- phase 9: the recurrent families, each alone on the card
    record["recurrent"] = run_recurrent(torch, KERNELS[:2], inputs, card)
    save_record(record)

    # -- phase 10: the multimodal and encoder-decoder families
    record["multimodal"] = run_multimodal(torch, inputs, card)
    save_record(record)

    # -- phase 11: training and the launchers
    record["training"] = run_training(torch, card)
    save_record(record)

    # -- phase 12: the sharding layer on NCCL ranks
    record["sharded"] = run_sharded(
        torch, record["training"]["starcoder2-3b"]["first_step"], card)
    save_record(record)

    # -- phase 13: the dry run and the simulator
    record["dry_run"] = run_phase13(torch, inputs, eres["eager"], card)
    record["run_s"] = time.perf_counter() - started
    save_record(record)
    print(f"chip_smoke: {record['run_s']:.1f} s", flush=True)

    # each kernel's launches on the path that runs it, counted where its
    # wrapper launches it: the eager serve (the graphed one ran the same
    # kernels, counted by name in its profile)
    path_launches = {m.NAME: eres["eager"]["launches"]
                     for m in engine_kmods}
    path_launches["chunked_prefill_attention"] = sres["launches"]
    kimi = fres["kimi-k2-1t-a32b"]
    kimi_launches = kimi["serves"]["eager"]["launches"]
    # device ms at kimi-k2's shapes: its heads (phase 8a) for the
    # attention kernels, phase 2's d112 / 7168-wide cases for the others
    d112_ms = {name: r["device_ms"]
               for name, r in kimi["kernels_d112"].items()}
    d112_ms["rope_kv"] = checks["rope_kv"]["d112"]["device_ms"]
    d112_ms["rms_norm"] = checks["rms_norm"]["add"][
        f"{RT_SLOTS}x{KIMI_D}"]["device_ms"]
    kernels = []
    for m in KERNELS:
        r = checks[m.NAME]
        entry = {
            "name": m.NAME, "route": "cuda", "source": m.SOURCE,
            "replaces": m.REPLACES,
            "launches": path_launches.get(m.NAME, ops_launches)[m.NAME],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if m.NAME in kimi_launches:
            # phase 8a's eager serve at kimi-k2's head dim 112
            entry["launches_d112"] = kimi_launches[m.NAME]
            entry["device_ms_d112"] = d112_ms[m.NAME]
        kernels.append(entry)
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
