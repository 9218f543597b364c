"""Operations and bytes the served requests need, and the H100's roofline.

Frozen from ``chip_smoke.py`` at commit
bdcad9e275c09ab563fad5e5900be9a462e243e1: ``bound`` and the peaks it reads
(``src/repro_torch/launch/analysis.py``: 989 TFLOP/s bf16 dense, 3.35 TB/s
HBM, per card), and the byte rules of ``check_decode`` (paged decode: q
read and the output written once, each live K and V position read once)
and ``check_ragged`` (fused prefill: q read and the output written once,
the new K and V read once and written to the pages once, each prefix
position read once).

Work is counted the way the requests need it, and the same rule holds for
the operations and the bytes:

  * a prompt counts as tokenized, without the bucket's left padding: its
    p tokens sit at positions 0..p-1;
  * a request of n output tokens needs p + n - 1 token forwards (the
    prompt, then each output token but the last fed back) and n rows of
    logits; no decode-window overhang, no dead rows, no padding chunk;
  * attention at position i reads the i + 1 keys and values before and at
    it, once;
  * a MoE token runs its k routed experts, the shared expert and the
    router, as if no choice were dropped.

A change that removes padding or overhang therefore raises the shares
these counts give; it cannot lower them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12          # bf16 dense, one H100 SXM
HBM_BW = 3.35e12             # bytes/s, one H100 SXM
BF16 = 2                     # bytes an element of the served dtype


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the HBM rate."""
    return max(bytes_moved / HBM_BW, flops / PEAK_FLOPS)


def _matmul_flops_per_token(model: dict) -> Tuple[float, float]:
    """(FLOPs of the weight products of one token through every layer,
    FLOPs of one row of logits)."""
    D, H, KV, hd = (model["d_model"], model["num_heads"],
                    model["num_kv_heads"], model["head_dim"])
    attn = 2 * D * hd * (2 * H + 2 * KV)
    n_mlp = 3 if model["mlp_act"] == "swiglu" else 2
    dense = attn + 2 * n_mlp * D * model["d_ff"]
    total = 0.0
    for kind in _kinds(model):
        if kind == "moe":
            Fe, K, E = (model["moe_d_ff"], model["experts_per_token"],
                        model["num_experts"])
            shared = model.get("num_shared_experts", 0)
            total += (attn + 2 * D * E + 6 * D * Fe * K
                      + 6 * D * Fe * shared)
        else:
            total += dense
    return total, 2 * D * model["vocab_size"]


def _kinds(model: dict):
    if model["family"] == "moe":
        k = model["num_dense_layers"]
        return ["dense"] * k + ["moe"] * (model["num_layers"] - k)
    return ["dense"] * model["num_layers"]


def _attn_keys(lo: int, hi: int) -> int:
    """Keys read by the queries at positions lo..hi-1: sum of (i + 1)."""
    return (hi * (hi + 1) - lo * (lo + 1)) // 2


def request_work(model: dict, requests: Iterable[Tuple[int, int, str]]
                 ) -> Dict[str, float]:
    """``requests``: (prompt tokens p, output tokens n, lane) of each
    finished request.  Returns the model's FLOPs over all of them; over
    the requests the card's paged path served (lane "gpu"), the FLOPs of
    their prompts (the forwards and the first token's logits) and the
    operations and bytes of the two engine kernels: the paged decode
    attention over the n - 1 fed-back tokens, the fused prefill attention
    over the prompt.  The kernels' block tables and lengths are not
    counted."""
    L = model["num_layers"]
    H, KV, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    per_tok, per_logit = _matmul_flops_per_token(model)
    out = {"model_flops": 0.0, "prompt_flops": 0.0, "decode_flops": 0.0,
           "decode_bytes": 0.0, "prefill_flops": 0.0, "prefill_bytes": 0.0,
           "tokens_out": 0, "tokens_in": 0}
    for p, n, lane in requests:
        fwd = p + n - 1
        keys_all = _attn_keys(0, fwd)
        out["model_flops"] += (fwd * per_tok + n * per_logit
                               + 4.0 * keys_all * H * hd * L)
        out["tokens_out"] += n
        out["tokens_in"] += p
        if lane != "gpu":
            continue
        dec_keys = _attn_keys(p, fwd)        # queries at p..p+n-2
        dec_q = n - 1
        out["decode_flops"] += 4.0 * dec_keys * H * hd * L
        out["decode_bytes"] += L * BF16 * (2 * dec_q * H * hd
                                           + 2 * dec_keys * KV * hd)
        pre_keys = _attn_keys(0, p)
        out["prompt_flops"] += (p * per_tok + per_logit
                                + 4.0 * pre_keys * H * hd * L)
        out["prefill_flops"] += 4.0 * pre_keys * H * hd * L
        out["prefill_bytes"] += L * BF16 * (2 * p * H * hd
                                            + 2 * 2 * p * KV * hd)
    return out
