"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437].

61L d_model=7168 128H (GQA kv=128) d_ff=2048 (per routed expert)
vocab=129280, MoE 256e top-8.  First 3 layers are dense (d_ff=18432 per the
V3 paper); the remaining 58 are MoE.  MLA: kv_lora=512, q_lora=1536,
rope=64, nope=128, v=128.  Sigmoid (aux-free-style) router.
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import LayerDef, MLAConfig, ModelConfig, MoEConfig, StageDef

_DENSE_FF = 18432      # V3 paper value for the 3 dense layers

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=_DENSE_FF,
    vocab_size=129280,
    head_dim=192,                       # nope 128 + rope 64
    stages=(
        StageDef((LayerDef("mla", "dense"),), 3),
        StageDef((LayerDef("mla", "moe"),), 58),
    ),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  router="sigmoid"),
    mtp_depth=1,                        # multi-token prediction head
    source="arXiv:2412.19437",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=48, d_ff=256, vocab_size=512,
        stages=(
            StageDef((LayerDef("mla", "dense"),), 1),
            StageDef((LayerDef("mla", "moe"),), 1),
        ),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=16,
                      nope_head_dim=32, v_head_dim=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                      router="sigmoid"),
        mtp_depth=0,
    )
