"""Architecture registry: ``--arch <id>`` lookup for every assigned config.

``get_config(arch_id)`` returns the full paper-exact ModelConfig;
``get_smoke_config(arch_id)`` returns the reduced same-family variant used
by the CPU smoke tests (2 layers, d_model<=512, <=4 experts).
"""

from __future__ import annotations

import importlib

from .base import INPUT_SHAPES, InputShape, ModelConfig, shape_applicable

_MODULES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "minitron-4b": "minitron_4b",
    "yi-6b": "yi_6b",
    "mixtral-8x22b": "mixtral_8x22b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "all_configs", "get_config", "get_smoke_config", "shape_applicable",
]
