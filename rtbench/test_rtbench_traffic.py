"""The chat traffic: fixed by the seed, the same work for every seed."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import harness  # noqa: E402

GEN = harness.load_module(HERE / "traffic" / "poisson_chat.py",
                          "rtbench_traffic_poisson_chat")
MIX = harness._json(HERE / "traffic" / "chat-rt.json")
BIG = 2**31 + 11


def _make(seed, rate=50.0, seconds=4.0, stream=0):
    return GEN.make(MIX, rate=rate, seconds=seconds, seed=seed,
                    num_slots=128, stream=stream)


def test_same_seed_same_traffic():
    a, b = _make(BIG), _make(BIG)
    assert a.requests == b.requests
    assert a.persona == b.persona and a.persona.batch_size == 128


def test_seeds_differ_in_order_not_in_work_or_arrivals():
    a, b = _make(BIG), _make(7)
    assert a.requests != b.requests
    assert [r["max_new_tokens"] for r in a.requests] == \
        [r["max_new_tokens"] for r in b.requests]
    assert sorted(r["text"] for r in a.requests) == \
        sorted(r["text"] for r in b.requests)
    assert [r["arrival"] for r in a.requests] == \
        [r["arrival"] for r in b.requests]


def test_schedule_spans_the_seconds_at_the_rate():
    t = _make(3, rate=50.0, seconds=4.0)
    assert len(t.requests) == 200
    arr = [r["arrival"] for r in t.requests]
    assert arr == sorted(arr)
    assert 3.5 < arr[-1] <= 4.0
    assert _make(3, stream=1).requests != t.requests


def test_mix_lengths():
    d = GEN.describe(MIX)
    assert d["prompt_words_max"] <= 32          # the row's input bucket
    assert 1 <= d["out_min"] and d["out_max"] <= 64   # its max_new_tokens
    assert 24.0 < d["out_mean"] < 27.0
