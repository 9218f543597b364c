"""Modality-frontend stubs for the vlm and audio architectures (PyTorch
port of ``repro.models.multimodal``).

As in the reference, the ViT/SigLIP vision encoder and the audio feature
extractor are not implemented: callers hand over precomputed patch or
frame embeddings of the right shape.  This module holds

  * the trainable projector that maps frontend embeddings into the
    language model's embedding space (LLaVA's ``mlp2x_gelu``, with the
    tanh GELU, ``jax.nn.gelu``'s default);
  * seeded random stand-ins for those embeddings (smoke runs, examples).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers


def init_projector(generator: torch.Generator, cfg, dtype, device) -> dict:
    """Two-layer (D, D) MLP projector with zero biases."""
    D = cfg.d_model
    return {
        "w1": layers.dense_init(generator, (D, D), dtype, device),
        "b1": torch.zeros((D,), dtype=dtype, device=device),
        "w2": layers.dense_init(generator, (D, D), dtype, device),
        "b2": torch.zeros((D,), dtype=dtype, device=device),
    }


def apply_projector(params: dict, emb: torch.Tensor) -> torch.Tensor:
    """emb (B, T_front, D) frontend embeddings -> LM embedding space, in
    the promoted dtype of ``emb`` and the weights (bf16 stubs into a
    float32 projector compute in float32, as JAX promotes them)."""
    w1 = params["w1"]
    x = emb.to(torch.promote_types(emb.dtype, w1.dtype))
    h = F.gelu(x @ w1 + params["b1"], approximate="tanh")
    return h @ params["w2"] + params["b2"]


def _stub(generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).to(dtype)


def stub_patch_embeddings(generator: torch.Generator, batch: int, cfg,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Standard normal stand-in for ViT anyres patch embeddings,
    (batch, num_patch_tokens, D), drawn in float32 on ``generator``'s
    device and cast to ``dtype``."""
    return _stub(generator, (batch, cfg.num_patch_tokens, cfg.d_model),
                 dtype)


def stub_frame_embeddings(generator: torch.Generator, batch: int, cfg,
                          dtype=torch.bfloat16) -> torch.Tensor:
    """Standard normal stand-in for conv-encoded audio frame embeddings,
    (batch, encoder_seq_len, D), drawn as ``stub_patch_embeddings``."""
    return _stub(generator, (batch, cfg.encoder_seq_len, cfg.d_model),
                 dtype)
