"""Architecture registry of the port: ``arch id`` -> ModelConfig.

Only the dense GQA decoders that the ported serving path runs are listed;
the remaining architectures wait for their mixers (see ROADMAP.md).
"""
from __future__ import annotations

from importlib import import_module

from ..models.config import ModelConfig

_MODULES = {
    "smollm-135m": "smollm_135m",
    "qwen2-0.5b": "qwen2_0_5b",
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
