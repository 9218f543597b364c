"""Model / run configuration dataclasses shared by every architecture.

Every assigned architecture gets one module in ``repro.configs`` exporting
``CONFIG`` (the full, paper-exact configuration) and ``smoke_config()``
(a reduced variant of the same family: 2 layers, d_model<=512, <=4 experts)
used by the CPU smoke tests.  The full configs are exercised only via the
dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single architecture description (one per assigned arch)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    window: Optional[int] = None      # sliding-window size (tokens); None = full
    rope_theta: float = 10_000.0
    # --- mlp ---
    d_ff: int = 0
    mlp_act: str = "swiglu"           # swiglu | gelu | relu
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    num_dense_layers: int = 0         # leading dense layers before MoE stack
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec","rec","attn")
    lru_width: int = 0
    local_window: int = 2048
    # --- encoder-decoder ---
    num_encoder_layers: int = 0
    encoder_seq_len: int = 4096       # fixed encoder memory length for decode shapes
    # --- multimodal stubs ---
    frontend: str = ""                # "" | vision | audio
    num_patch_tokens: int = 0         # VLM: patch embeddings prepended to prompt
    # --- numerics ---
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = True
    # --- citation for the assignment table ---
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded for shardability across <=16-way model parallelism.

        Padding the embedding/vocab axis to a multiple of 2048 makes every
        assigned vocab divisible by the model axis (16) and by 2*16 for the
        multi-pod mesh.  Logit positions >= vocab_size are masked to -inf
        in the loss / sampler.
        """
        return _round_up(self.vocab_size, 2048)

    @property
    def attn_groups(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_subquadratic(self) -> bool:
        """Whether decode state is bounded => long_500k eligible."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True
        if self.window is not None:
            return True
        return False

    # -------------------------- parameter counting --------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D model-FLOPs roofline)."""
        D, V = self.d_model, self.padded_vocab
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        per_attn = D * self.num_heads * self.head_dim * 2 + \
            D * self.num_kv_heads * self.head_dim * 2
        if self.family == "ssm":
            di, nheads, ns = self.ssm_d_inner, self.ssm_heads, self.ssm_state
            cw, g = self.ssm_conv_width, self.ssm_groups
            per_layer = (D * (2 * di + 2 * g * ns + nheads)      # in_proj
                         + (di + 2 * g * ns) * cw                 # conv
                         + nheads * 2                             # A_log, D
                         + di                                     # gated norm
                         + di * D)                                # out_proj
            n += self.num_layers * per_layer + D
            return n
        if self.family == "hybrid":
            lw = self.lru_width or D
            rec_layer = D * lw * 2 + lw * self.ssm_conv_width + lw * 4 + lw * D
            attn_layer = per_attn
            mlp = 3 * D * self.d_ff
            pat = self.block_pattern or ("rec",)
            n_attn = sum(1 for i in range(self.num_layers)
                         if pat[i % len(pat)] == "attn")
            n_rec = self.num_layers - n_attn
            n += n_rec * (rec_layer + mlp + 2 * D) + \
                n_attn * (attn_layer + mlp + 2 * D) + D
            return n
        mlp_mult = 3 if self.mlp_act == "swiglu" else 2
        dense_mlp = mlp_mult * D * self.d_ff
        if self.family == "moe":
            expert_mlp = mlp_mult * D * self.moe_d_ff
            moe_layer = (per_attn + self.num_experts * expert_mlp
                         + self.num_shared_experts * expert_mlp
                         + D * self.num_experts + 2 * D)
            dense_layer = per_attn + dense_mlp + 2 * D
            n += (self.num_dense_layers * dense_layer
                  + (self.num_layers - self.num_dense_layers) * moe_layer + D)
            return n
        per_layer = per_attn + dense_mlp + 2 * D
        n += self.num_layers * per_layer + D
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            enc_layer = per_attn + dense_mlp + 2 * D
            n += self.num_encoder_layers * enc_layer + D
            n += self.num_layers * (per_attn + D)  # cross attn
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        mlp_mult = 3 if self.mlp_act == "swiglu" else 2
        expert_mlp = mlp_mult * self.d_model * self.moe_d_ff
        inactive = (self.num_layers - self.num_dense_layers) * \
            (self.num_experts - self.experts_per_token) * expert_mlp
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run combination.

    Returns (ok, reason-if-skipped).  Mirrors DESIGN.md §4.
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full quadratic attention; 512k decode KV state is "
                       "unbounded — skipped per spec (no SWA/block-sparse "
                       "variant for this arch)")
    return True, ""
