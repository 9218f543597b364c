"""LLaVA-NeXT (Mistral-7B backbone) — anyres VLM
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Assignment row: [vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.  The ViT/SigLIP frontend is a STUB per the assignment
carve-out: input_specs() provides precomputed anyres patch embeddings
(num_patch_tokens=2880, the anyres maximum) which the trainable
mlp2x_gelu projector maps into the LM embedding space.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    vocab_size=32000,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    num_patch_tokens=2880,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (LLaVA-NeXT)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm", num_layers=2,
        d_model=256, vocab_size=2048, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, mlp_act="swiglu", frontend="vision",
        num_patch_tokens=16, source=CONFIG.source)
