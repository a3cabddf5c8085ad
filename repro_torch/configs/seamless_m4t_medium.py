"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  Encoder-decoder:
12 encoder + 12 decoder layers (n_layers counts the decoder stack).  The
mel-spectrogram + conv feature extractor frontend is a STUB per the brief:
``input_specs()`` supplies precomputed frame embeddings (dim 1024) which the
model consumes through a learned projector.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import LayerDef, ModelConfig, StageDef

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    stages=(StageDef((LayerDef("attn", "dense", cross_attn=True),), 12),),
    encoder_stages=(StageDef((LayerDef("attn", "dense"),), 12),),
    modality="audio",
    modality_embed_dim=1024,          # stub-provided audio frame embeddings
    source="arXiv:2308.11596",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512,
        stages=(StageDef((LayerDef("attn", "dense", cross_attn=True),), 2),),
        encoder_stages=(StageDef((LayerDef("attn", "dense"),), 2),),
        modality_embed_dim=64,
    )
