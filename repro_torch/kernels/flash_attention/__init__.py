"""Blocked online-softmax (flash) attention: CUDA kernels (forward and
backward), wrappers, the model-layout adapter, plain versions."""
from .ops import FlashAttentionFn, flash_attention, flash_attention_bwd, \
    mha_attention
from .ref import attention_ref, flash_attention_bwd_ref, \
    flash_attention_ref, gqa_attention_ref

__all__ = ["FlashAttentionFn", "attention_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_ref", "gqa_attention_ref", "mha_attention"]
