"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Super-block of 8 layers (attention at index 3, Mamba elsewhere; MoE on odd
indices, dense on even), repeated 9 times.  Attention layers use a sliding
window so long_500k decode state stays O(window).
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import LayerDef, MambaConfig, ModelConfig, MoEConfig, StageDef


def _superblock() -> tuple[LayerDef, ...]:
    return tuple(
        LayerDef(
            mixer="attn" if i == 3 else "mamba",
            ffn="moe" if i % 2 == 1 else "dense",
        )
        for i in range(8)
    )


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    stages=(StageDef(_superblock(), 9),),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, n_shared=0),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
        vocab_size=512,
        stages=(StageDef(
            (LayerDef("mamba", "dense"), LayerDef("attn", "moe"),
             LayerDef("mamba", "moe"), LayerDef("mamba", "dense")), 1),),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, n_shared=0),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    )
