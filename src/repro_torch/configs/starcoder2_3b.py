"""StarCoder2-3B — code LM, GQA + RoPE [arXiv:2402.19173].

Assignment row: [dense] 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.  Full attention per the assignment row (no SWA listed), so
long_500k is skipped for this arch (see DESIGN.md §4).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    vocab_size=49152,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    mlp_act="gelu",
    rope_theta=100_000.0,
    source="arXiv:2402.19173 (StarCoder 2 and The Stack v2)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family="dense", num_layers=2,
        d_model=256, vocab_size=2048, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, mlp_act="gelu", source=CONFIG.source)
