#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. card — name and power limit (``nvidia-smi``), torch/CUDA versions,
     and the build of all six CUDA kernels from ``src/repro_torch/csrc``,
     one ``nvcc`` per source, all started together; the ``-Xptxas -v``
     registers, spills and barriers of the five tensor-core kernels and
     RMSNorm (the attention kernels' shared memory is dynamic, sized at
     launch, so ptxas does not see it);
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
     plans and the grids).  Then the kernel API
     (``kernels.ops``) as
     an entry point: every op once at those shapes, launch counts reset
     just before and read just after, outputs bit-equal to the kernels'
     own;
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
     requests at full width; the kernels' launch counts are reset just
     before and read just after.  The same serve runs once more under
     ``torch.profiler`` for the device's busy time and the kernels' share
     (the paged decode's split and combine kernels, the fused prefill).

Then one JSON line of kernel results (each kernel's launches from the path
that runs it: decode and ragged prefill from phase 4, chunked prefill from
phase 3's single-chunk path, the other three from phase 2's ops path), the
card line, and as the last line ``{"ok": true, "device": {...}}``.  Needs
a CUDA card; imports nothing of JAX.
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

# H100 SXM peaks (NVIDIA data sheet): bf16 on the tensor cores, float32
# outside them (elementwise work such as RMSNorm)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

# the ops-path shapes beyond the serving path's
DECODE_S = 2048                  # contiguous flash decode: B=16 rows
FA_S = 2048                      # flash attention, starcoder2-3b heads
DANUBE = dict(H=32, KV=8, D=120, S=6144, window=4096)   # h2o-danube-3-4b
RMS_D = 3072                     # starcoder2-3b d_model


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


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
    top["ops"] = calls
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


# the device kernels of the engine path's two port kernels
# (csrc/paged_decode_attention.cu, csrc/ragged_chunked_prefill.cu)
PROFILE_TAGS = ("paged_decode_split_kernel", "paged_decode_combine_kernel",
                "ragged_prefill_kernel")


def profile_window(torch, fn, warm: bool = True, cpu: bool = True) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall time, the summed
    device time of its kernels (busy), the idle share, and the engine
    path's port kernels' device time and share of the busy time (the
    paged decode as its split and combine kernels and their sum
    ``paged_decode``, the fused prefill).  "not measured" if
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
        for tag in PROFILE_TAGS:
            if tag in e.name():
                ours[tag] = ours.get(tag, 0.0) + t
    ours["paged_decode"] = sum(ours.get(tag, 0.0) for tag in PROFILE_TAGS
                               if tag.startswith("paged_decode"))
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
    for name, lines in ptxas_report(("flash_attention",
                                     "flash_decode_attention",
                                     "paged_decode_attention",
                                     "ragged_chunked_prefill",
                                     "chunked_prefill_attention",
                                     "rms_norm")).items():
        for ln in lines:
            print(f"ptxas {name}: {ln}", flush=True)

    # -- phase 2: kernels vs plain versions, then the ops path
    checks = {}
    for m, check in zip(KERNELS, (check_decode, check_ragged,
                                  check_chunked_prefill, check_rms_norm,
                                  check_flash_attention, check_flash_decode)):
        checks[m.NAME] = check(torch, F, m)
        shown = {k: v for k, v in checks[m.NAME].items() if k != "ops"}
        print(f"kernel {m.NAME}: {json.dumps(shown)}", flush=True)
    ops_launches = run_ops_path(
        torch, KERNELS, [c for r in checks.values() for c in r["ops"]])
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
    eres = run_engine(torch, cfg, params, KERNELS[:2])
    print(f"engine [{card}]: {json.dumps(eres)}", flush=True)

    # each kernel's launches on the path that runs it
    path_launches = {
        "paged_decode_attention": eres["launches"],
        "ragged_chunked_prefill": eres["launches"],
        "chunked_prefill_attention": sres["launches"],
    }
    kernels = []
    for m in KERNELS:
        r = checks[m.NAME]
        kernels.append({
            "name": m.NAME, "route": "cuda", "source": m.SOURCE,
            "replaces": m.REPLACES,
            "launches": path_launches.get(m.NAME, ops_launches)[m.NAME],
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
