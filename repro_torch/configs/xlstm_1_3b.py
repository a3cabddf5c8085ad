"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  xLSTM[7:1] ratio:
super-block of 7 mLSTM + 1 sLSTM, repeated 6 times.  Blocks carry their own
up/down projections, so there is no separate FFN (d_ff=0).
"""
from __future__ import annotations

from dataclasses import replace

from ..models.config import LayerDef, ModelConfig, StageDef, XLSTMConfig


def _superblock() -> tuple[LayerDef, ...]:
    return tuple(
        LayerDef(mixer="mlstm" if i < 7 else "slstm", ffn="none")
        for i in range(8)
    )


CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    stages=(StageDef(_superblock(), 6),),
    xlstm=XLSTMConfig(),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        vocab_size=512,
        stages=(StageDef(
            (LayerDef("mlstm", "none"), LayerDef("slstm", "none")), 1),),
    )
