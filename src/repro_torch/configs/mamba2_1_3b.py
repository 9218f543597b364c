"""Mamba2-1.3B — SSD state-space model, attention-free [arXiv:2405.21060].

Assignment row: [ssm] 48L d_model=2048 (attn-free) d_ff=0 vocab=50280,
ssm_state=128.  Decode is an O(1) recurrent-state update, so all decode
shapes including long_500k are eligible.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_groups=1,
    source="arXiv:2405.21060 (Transformers are SSMs — Mamba-2 / SSD)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke", family="ssm", num_layers=2, d_model=256,
        vocab_size=2048, ssm_state=16, ssm_head_dim=32, ssm_expand=2,
        ssm_conv_width=4, ssm_chunk=8, source=CONFIG.source)
