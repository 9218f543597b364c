"""Yi-6B — llama-architecture GQA model [arXiv:2403.04652].

Assignment row: [dense] 32L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    vocab_size=64000,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    mlp_act="swiglu",
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    source="arXiv:2403.04652 (Yi: Open Foundation Models by 01.AI)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", family="dense", num_layers=2, d_model=256,
        vocab_size=2048, num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
        mlp_act="swiglu", tie_embeddings=False, source=CONFIG.source)
