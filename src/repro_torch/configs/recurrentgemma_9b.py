"""RecurrentGemma-9B — Griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427].

Assignment row: [hybrid] 38L d_model=4096 16H (GQA kv=1 = MQA)
d_ff=12288, vocab=256000.  Block pattern (rec, rec, attn_local) with a
2048-token local-attention window; recurrent state + windowed KV are both
bounded, so long_500k is eligible.  38 = 12x3 + 2 -> 12 scanned
superblocks plus a (rec, rec) tail.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    vocab_size=256000,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    mlp_act="swiglu",
    block_pattern=("rec", "rec", "attn_local"),
    lru_width=4096,
    local_window=2048,
    ssm_conv_width=4,
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid", num_layers=3,
        d_model=256, vocab_size=2048, num_heads=8, num_kv_heads=1,
        head_dim=32, d_ff=512, mlp_act="swiglu",
        block_pattern=("rec", "rec", "attn_local"), lru_width=256,
        local_window=64, source=CONFIG.source)
