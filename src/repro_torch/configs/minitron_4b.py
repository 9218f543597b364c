"""Minitron-4B — width/depth-pruned Nemotron-4 [arXiv:2407.14679].

Assignment row: [dense] 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000.  Nemotron uses squared-ReLU MLPs (approximated here by
relu; mlp_mult=2) and untied embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    vocab_size=256000,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    mlp_act="relu",
    tie_embeddings=False,
    source="arXiv:2407.14679 (Minitron / Compact LMs via pruning+distill)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke", family="dense", num_layers=2, d_model=256,
        vocab_size=2048, num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
        mlp_act="relu", tie_embeddings=False, source=CONFIG.source)
