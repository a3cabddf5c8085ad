"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decode_attention_ref

NAME = "decode_attention"


def _launcher():
    fn = _build.load(NAME).decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_cache: torch.Tensor,      # [B, S, KV, D]
    v_cache: torch.Tensor,
    positions: torch.Tensor,    # [B, S] int32 (-1 = empty slot)
    pos: int,                   # current absolute position
    *,
    window: int = 0,
) -> torch.Tensor:
    """One-token GQA attention over a position-tracked cache -> [B, H, D]."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, positions, pos,
                                    window=window)
    b, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    _build.check_inputs(
        NAME, (q, k_cache, v_cache), (positions,),
        shapes_ok=(k_cache.shape == (b, s, kv, d)
                   and v_cache.shape == k_cache.shape
                   and positions.shape == (b, s) and h % kv == 0),
        head_dim=d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions.data_ptr(), out.data_ptr(), b, s, h, kv, d, int(pos),
            int(window), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, NAME)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
