"""The operation and byte counts against counts by hand."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import counting  # noqa: E402

# one layer of each kind, numbers small enough to count by hand
DENSE = {"family": "dense", "num_layers": 1, "d_model": 4, "vocab_size": 10,
         "num_heads": 2, "num_kv_heads": 1, "head_dim": 2, "d_ff": 8,
         "mlp_act": "gelu"}
MOE = {"family": "moe", "num_layers": 2, "num_dense_layers": 1,
       "d_model": 4, "vocab_size": 10, "num_heads": 2, "num_kv_heads": 1,
       "head_dim": 2, "d_ff": 8, "mlp_act": "swiglu", "num_experts": 3,
       "experts_per_token": 2, "moe_d_ff": 5, "num_shared_experts": 1}


def test_two_requests_dense():
    # request A: 3 prompt tokens, 2 output tokens, served on the card;
    # request B: 2 prompt tokens, 1 output token, offloaded
    w = counting.request_work(DENSE, [(3, 2, "gpu"), (2, 1, "cpu")])
    # weights a token: q 4*2*2 + k 4*1*2 + v 4*1*2 + o 2*2*4 = 48 MACs,
    # gelu MLP 4*8 + 8*4 = 64 MACs -> 224 FLOPs; logits 4*10 MACs = 80
    per_tok, per_logit = 224, 80
    # A: forwards at positions 0..3 (3 prompt + 1 fed back), keys 1+2+3+4
    # = 10; B: forwards at 0..1, keys 1+2 = 3; 4 FLOPs a key a head dim
    # a query head
    attn = 4 * (10 + 3) * 2 * 2
    assert w["model_flops"] == (4 + 2) * per_tok + (2 + 1) * per_logit + attn
    # kernels: A only; decode: the query at position 3 reads 4 keys
    assert w["decode_flops"] == 4 * 4 * 2 * 2
    assert w["decode_bytes"] == 2 * (2 * 1 * 2 * 2 + 2 * 4 * 1 * 2)
    # prefill: keys 1+2+3 = 6; q and out 3*2*2 each, new k/v 3*1*2 each
    # read and written
    assert w["prefill_flops"] == 4 * 6 * 2 * 2
    assert w["prefill_bytes"] == 2 * (2 * 3 * 2 * 2 + 4 * 3 * 1 * 2)
    assert w["prompt_flops"] == 3 * per_tok + per_logit + 4 * 6 * 2 * 2
    assert (w["tokens_in"], w["tokens_out"]) == (5, 3)


def test_moe_layer_counts_its_chosen_experts():
    w = counting.request_work(MOE, [(1, 1, "gpu")])
    attn = 2 * 48
    dense_mlp = 2 * 3 * 4 * 8
    # router 4*3, two experts of 3 products 4x5, the shared one
    moe = 2 * 4 * 3 + 2 * 2 * 3 * 4 * 5 + 2 * 3 * 4 * 5
    assert w["model_flops"] == (2 * attn + dense_mlp + moe + 80
                                + 4 * 1 * 2 * 2 * 2)
    assert w["decode_flops"] == 0 and w["decode_bytes"] == 0


def test_bound_takes_the_larger_term():
    assert counting.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert counting.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert counting.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
