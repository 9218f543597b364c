"""SeamlessM4T-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

Assignment row: [audio] 24L d_model=1024 16H (GQA kv=16 = MHA) d_ff=8192
vocab=256206.  Only the TRANSFORMER BACKBONE is implemented: the
mel-spectrogram + conformer feature extractor is a stub — input_specs()
provides precomputed frame embeddings (encoder_seq_len=4096) consumed by
a 24-layer bidirectional encoder; the 24-layer decoder cross-attends to
the encoder memory.  Full attention: long_500k skipped (DESIGN.md §4).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    d_model=1024,
    vocab_size=256206,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    mlp_act="gelu",
    num_encoder_layers=24,
    encoder_seq_len=4096,
    frontend="audio",
    tie_embeddings=False,
    source="arXiv:2308.11596 (SeamlessM4T)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke", family="encdec", num_layers=2,
        d_model=256, vocab_size=2048, num_heads=8, num_kv_heads=8,
        head_dim=32, d_ff=512, mlp_act="gelu", num_encoder_layers=2,
        encoder_seq_len=32, frontend="audio", tie_embeddings=False,
        source=CONFIG.source)
