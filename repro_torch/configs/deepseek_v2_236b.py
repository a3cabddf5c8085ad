"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

60L d_model=5120 128H (GQA kv=128) d_ff=1536 (per routed expert)
vocab=102400.  First layer dense (d_ff=12288 per the V2 paper).
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import LayerDef, MLAConfig, ModelConfig, MoEConfig, StageDef

_DENSE_FF = 12288      # V2 paper value for the dense first layer

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=_DENSE_FF,
    vocab_size=102400,
    head_dim=192,
    stages=(
        StageDef((LayerDef("mla", "dense"),), 1),
        StageDef((LayerDef("mla", "moe"),), 59),
    ),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  router="softmax"),
    source="arXiv:2405.04434",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=48, d_ff=256, vocab_size=512,
        stages=(
            StageDef((LayerDef("mla", "dense"),), 1),
            StageDef((LayerDef("mla", "moe"),), 1),
        ),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, n_shared=2,
                      router="softmax"),
    )
