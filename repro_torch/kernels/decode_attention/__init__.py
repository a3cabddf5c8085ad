"""Single-token GQA decode attention: CUDA kernel, wrapper, its
model-layout adapter, plain version."""
from .ops import cached_decode_attention, decode_attention
from .ref import decode_attention_ref

__all__ = ["cached_decode_attention", "decode_attention",
           "decode_attention_ref"]
