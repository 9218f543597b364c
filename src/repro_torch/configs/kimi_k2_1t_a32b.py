"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 [arXiv:2501.kimi2].

Assignment row: [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8.  Per the K2 model card the first layer is
dense (d_ff 18432) and one shared expert accompanies the routed ones; the
assigned d_ff=2048 is the per-expert (moe) intermediate size.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    vocab_size=163840,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=18432,              # dense prefix layer
    mlp_act="swiglu",
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2048,
    num_shared_experts=1,
    num_dense_layers=1,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2 (Kimi K2 tech report / model card)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b-smoke", family="moe", num_layers=2,
        d_model=256, vocab_size=2048, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, mlp_act="swiglu", num_experts=4,
        experts_per_token=2, moe_d_ff=128, num_shared_experts=1,
        num_dense_layers=1, source=CONFIG.source)
