"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954].

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=352,
        vocab_size=512, stages=(),
    )
