"""Architecture registry of the port: ``arch id`` -> ModelConfig.

Every architecture of the JAX package's registry: the dense GQA decoders,
llava-next-34b's modality prefix, seamless-m4t-medium's encoder-decoder,
xLSTM, the MLA + MoE DeepSeek models and Jamba's Mamba + attention + MoE
hybrid.
"""
from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

_MODULES = {
    "smollm-135m": "smollm_135m",
    "qwen2-0.5b": "qwen2_0_5b",
    "xlstm-1.3b": "xlstm_1_3b",
    "deepseek-7b": "deepseek_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return import_module(f".{_MODULES[arch]}", __package__).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    return import_module(f".{_MODULES[arch]}", __package__).smoke_config()
