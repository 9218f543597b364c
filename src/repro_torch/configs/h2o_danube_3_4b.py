"""H2O-Danube3-4B — llama+mistral mix with SWA [arXiv:2401.16818].

Assignment row: [dense] 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, sliding-window attention (mistral-style, window 4096) —
long_500k eligible.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    mlp_act="swiglu",
    window=4096,
    source="arXiv:2401.16818 (H2O-Danube series)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense", num_layers=2,
        d_model=256, vocab_size=2048, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, mlp_act="swiglu", window=64,
        source=CONFIG.source)
