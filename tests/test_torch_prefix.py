"""PyTorch port: the prefix cache against the reference.

  * ``kvcache/prefix.py`` — the port's copy of ``block_hashes`` and
    ``PrefixCache`` driven in lockstep with the reference's through the
    same seeded admit / commit / free sequences over a small pool: the
    same plans, hashes, tables, LRU evictions, allocator failures and
    stats at every step;
  * the engine with ``prefix_cache=True``, stall and chunked prefill —
    every scheduling field and the hit / CoW / eviction counters against
    ``simulate_continuous(prefix_cache=True, prompt_tokens=...)`` bit for
    bit, the tight block budget included; greedy tokens identical with
    the cache on and off, and tokens and the page pool equal to the JAX
    engine's with the cache on;
  * ``persist_prefix_cache=True`` — two serves against one
    ``make_prefix_state`` of the simulator, the second warmer than the
    first, tokens unchanged, the pool whole after ``clear()``.

The workload shares prompt prefixes: most prompts are 8 words whose first
block (4 tokens) is common to all and whose second block repeats every
fifth request (a full match, so copy-on-write runs); every fourth request
is an unshared corpus text.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_engine_setup as es  # noqa: E402

from repro.core import simulator  # noqa: E402
from repro.kvcache import allocator as jalloc  # noqa: E402
from repro.kvcache import prefix as jprefix  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro_torch.kvcache import allocator as talloc  # noqa: E402
from repro_torch.kvcache import prefix as tprefix  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402

PAGED = dict(mode="continuous", kv="paged", kv_block_size=es.BS,
             prefix_cache=True)
CHUNKED = dict(prefill="chunked", chunk_size=es.CHUNK,
               token_budget=es.BUDGET)


# ---------------------------------------------------------------------------
# PrefixCache and block_hashes, in lockstep with the reference
# ---------------------------------------------------------------------------


def _drive(alloc_mod, prefix_mod, seed: int) -> list:
    """A seeded sequence of admissions, commits and frees over a 12-block
    pool; returns everything observable after each operation."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 6, 16).tolist() for _ in range(3)]
    alloc = alloc_mod.BlockAllocator(12, 4)
    pc = prefix_mod.PrefixCache(alloc, 4)
    live, prompts, trace = [], {}, []
    for seq in range(60):
        op = rng.integers(0, 3)
        if op == 0 or not live:
            toks = stems[rng.integers(0, 3)][:rng.integers(1, 15)]
            toks = toks + rng.integers(1, 6, rng.integers(0, 3)).tolist()
            try:
                plan = pc.admit(seq, toks)
            except alloc_mod.OutOfBlocksError:
                alloc.free_sequence(seq)
                trace.append(("oom", seq))
                continue
            live.append(seq)
            prompts[seq] = toks
            trace.append(("admit", seq, plan.start, plan.matched_blocks,
                          list(plan.cow), prefix_mod.block_hashes(toks, 4)))
        elif op == 1:
            seq_id = live[rng.integers(0, len(live))]
            trace.append(("commit", seq_id, pc.commit(seq_id,
                                                      prompts[seq_id])))
        else:
            seq_id = live.pop(rng.integers(0, len(live)))
            trace.append(("free", seq_id, alloc.free_sequence(seq_id)))
        trace.append((sorted(pc.stats().items()), alloc.num_free,
                      {s: alloc.table(s) for s in live},
                      list(pc._entries.items())))
    for s in live:
        alloc.free_sequence(s)
    trace.append(("clear", pc.clear(), alloc.num_free))
    alloc.check_no_leaks()
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_lockstep_with_reference(seed):
    want = _drive(jalloc, jprefix, seed)
    got = _drive(talloc, tprefix, seed)
    assert got == want
    kinds = {t[0] for t in want if isinstance(t[0], str)}
    assert {"admit", "commit", "free"} <= kinds


def test_block_hashes_and_collision_match_reference():
    toks = np.random.default_rng(7).integers(0, 2**31, 37).tolist()
    for bs in (1, 4, 16):
        assert tprefix.block_hashes(toks, bs) == jprefix.block_hashes(toks,
                                                                      bs)
    # a forged entry with the right hash and other tokens reads as a miss
    for alloc_mod, prefix_mod in ((jalloc, jprefix), (talloc, tprefix)):
        alloc = alloc_mod.BlockAllocator(8, 4)
        pc = prefix_mod.PrefixCache(alloc, 4)
        pc.admit(0, [1, 2, 3, 4])
        pc.commit(0, [1, 2, 3, 4])
        h = prefix_mod.block_hashes([1, 2, 3, 4], 4)[0]
        pc._entries[h] = (pc._entries[h][0], (9, 9, 9, 9))
        plan = pc.admit(1, [1, 2, 3, 4])
        assert plan.matched_blocks == 0 and not plan.cow
    with pytest.raises(ValueError, match="block_size"):
        tprefix.PrefixCache(talloc.BlockAllocator(8, 4), 8)


# ---------------------------------------------------------------------------
# engine with the cache on
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    s = es.make_setup()
    corpus = s["texts"]
    words = [(t.split() * 2)[:4] for t in corpus[:5]]
    s["texts"] = [corpus[i] if i % 4 == 0 else
                  " ".join(["shared", "system", "prompt", "here"]
                           + words[i % 5])
                  for i in range(len(es.CAPS))]
    return s


@pytest.fixture(scope="module")
def serve(setup):
    memo = {}

    def _serve(policy_name, **kw):
        key = (policy_name, tuple(sorted(kw.items())))
        if key not in memo:
            eng = es.port_engine(setup, policy_name, **PAGED, **kw)
            res = eng.serve(es.requests(tengine, setup["texts"]))
            memo[key] = (eng, res)
        return memo[key]

    return _serve


def _sim(s, policy_name, n, kv_num_blocks, prefill_kw, **kw):
    return simulator.simulate_continuous(
        es.sim_tasks(s, s["texts"]), es.jax_policy(s, policy_name),
        kv_block_size=es.BS, kv_num_blocks=kv_num_blocks,
        prompt_len=es.BUCKET, prefix_cache=True,
        prompt_tokens=es.prompt_tokens_fn(s["cfg"]), decode_steps=n,
        **prefill_kw, **kw)


@pytest.mark.parametrize("prefill", ["stall", "chunked"])
@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
@pytest.mark.parametrize("n", [1, 4])
def test_engine_vs_sim(setup, serve, prefill, policy_name, n):
    pkw = CHUNKED if prefill == "chunked" else {}
    eng, res = serve(policy_name, decode_steps=n, **pkw)
    assert res["cow_copies"] > 0 and res["prefix_hit_rate"] > 0.3
    assert res["exec_cache_misses"] > 0
    es.assert_sim_parity(res, _sim(setup, policy_name, n, eng.kv_num_blocks,
                                   pkw, num_slots=es.SLOTS))
    eng.prefix_cache.clear()
    eng.allocator.check_no_leaks()


@pytest.mark.parametrize("prefill", ["stall", "chunked"])
@pytest.mark.parametrize("policy_name", ["fifo", "rt-lm"])
def test_engine_vs_sim_tight_budget(setup, serve, prefill, policy_name):
    """Memory rejections, LRU eviction and sharing together."""
    pkw = CHUNKED if prefill == "chunked" else {}
    eng, res = serve(policy_name, decode_steps=2, **pkw, **es.TIGHT)
    assert res["rejected_for_memory"] > 0
    assert res["prefix_evictions"] > 0
    es.assert_sim_parity(res, _sim(setup, policy_name, 2, es.TIGHT[
        "kv_num_blocks"], pkw, num_slots=es.TIGHT["num_slots"]))
    eng.prefix_cache.clear()
    eng.allocator.check_no_leaks()


@pytest.mark.parametrize("prefill", ["stall", "chunked"])
def test_tokens_identical_with_and_without_the_cache(setup, serve,
                                                     prefill):
    pkw = CHUNKED if prefill == "chunked" else {}
    _, warm = serve("rt-lm", decode_steps=2, **pkw)
    cold_eng = es.port_engine(setup, "rt-lm", decode_steps=2,
                              **{**PAGED, "prefix_cache": False}, **pkw)
    cold = cold_eng.serve(es.requests(tengine, setup["texts"]))
    if prefill == "stall":
        # the cache changes when prefill compute happens, not the stall
        # loop's admissions and evictions (chunked prefill finishes a
        # shorter suffix sooner, so its order may move)
        assert warm["completion_order"] == cold["completion_order"]
    assert es.tokens(warm) == es.tokens(cold)
    for t in warm["tasks"]:
        assert t.task.out_len == es.CAPS[t.task.task_id]
    assert cold["prefix_hit_rate"] == cold["cow_copies"] == 0


@pytest.mark.parametrize("prefill", ["stall", "chunked"])
def test_tokens_match_jax_engine_with_the_cache(setup, serve, prefill):
    pkw = CHUNKED if prefill == "chunked" else {}
    eng, res = serve("fifo", decode_steps=1, **pkw)
    jeng = es.jax_engine(setup, "fifo", decode_steps=1, **PAGED, **pkw)
    want = jeng.serve(es.requests(jengine, setup["texts"]))
    assert res["completion_order"] == want["completion_order"]
    assert es.tokens(res) == es.tokens(want)
    # the pools left behind, the cached (shared and copied) blocks
    # included: the two allocators hand out the same block ids
    es.assert_kv(eng.paged_cache.state["layers"], jeng.paged_cache.state,
                 setup["cfg"])
    for key in ("prefix_hit_rate", "cached_tokens_reused", "cow_copies",
                "exec_cache_hits", "exec_cache_misses"):
        assert res[key] == want[key]


@pytest.mark.parametrize("prefill", ["stall", "chunked"])
def test_persistent_cache_across_serves(setup, prefill):
    pkw = CHUNKED if prefill == "chunked" else {}
    eng = es.port_engine(setup, "fifo", persist_prefix_cache=True, **PAGED,
                         **pkw)
    ra = eng.serve(es.requests(tengine, setup["texts"]))
    pool = eng.paged_cache
    rb = eng.serve(es.requests(tengine, setup["texts"]))
    assert eng.paged_cache is pool                   # the pool survived
    assert es.tokens(ra) == es.tokens(rb)
    assert rb["prefix_hit_rate"] > ra["prefix_hit_rate"]
    assert rb["pipeline"]["persist_prefix_cache"] is True
    state = simulator.make_prefix_state(eng.kv_num_blocks, es.BS)
    for r in (ra, rb):
        es.assert_sim_parity(r, _sim(setup, "fifo", 1, eng.kv_num_blocks,
                                     pkw, num_slots=es.SLOTS,
                                     prefix_state=state))
    # what stays pinned is the cache's own blocks, and nothing else
    assert (eng.allocator.num_free + eng.prefix_cache.num_cached_blocks
            == eng.kv_num_blocks)
    eng.prefix_cache.clear()
    eng.allocator.check_no_leaks()
