"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=320,
        vocab_size=512, stages=(),
    )
