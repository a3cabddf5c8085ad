"""llava-next-34b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  Decoder-only LM
consuming projected vision-patch embeddings.  The ViT encoder + anyres tile
splitter is a STUB per the brief: ``input_specs()`` supplies precomputed
patch embeddings (dim 1024, up to 5 tiles x 576 patches = 2880 tokens
prepended to the text); the projector + LM are real.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import ModelConfig

N_IMAGE_TOKENS = 2880       # anyres: base tile + 4 crops, 576 patches each

CONFIG = ModelConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    modality="vision",
    modality_embed_dim=1024,
    n_modality_tokens=N_IMAGE_TOKENS,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512, stages=(), modality_embed_dim=64,
        n_modality_tokens=8,
    )
