"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=96, n_heads=3, n_kv_heads=3, d_ff=256,
        vocab_size=512, stages=(),
    )
