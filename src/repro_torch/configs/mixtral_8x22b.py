"""Mixtral 8x22B — sparse MoE, 8 experts top-2, SWA [arXiv:2401.04088].

Assignment row: [moe] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, sliding-window attention (window 4096, as in
the Mistral/Mixtral lineage) — which bounds decode KV state and makes the
long_500k shape eligible.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    vocab_size=32768,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    mlp_act="swiglu",
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    window=4096,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088 (Mixtral of Experts)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe", num_layers=2, d_model=256,
        vocab_size=2048, num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
        mlp_act="swiglu", num_experts=4, experts_per_token=2, moe_d_ff=512,
        window=64, source=CONFIG.source)
