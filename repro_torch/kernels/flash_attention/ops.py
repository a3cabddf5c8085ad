"""Wrapper of the flash attention kernel (``csrc/flash_attention.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

NAME = "flash_attention"


def _launcher():
    fn = _build.load(NAME).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, S, KV, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,        # [T] int32 absolute positions
    k_pos: torch.Tensor,        # [S] int32
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Full-sequence GQA attention in the model's layout -> [B, T, H, D]."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window)
    b, t, h, d = q.shape
    _, s, kv, _ = k.shape
    _build.check_inputs(
        NAME, (q, k, v), (q_pos, k_pos),
        shapes_ok=(k.shape == (b, s, kv, d) and v.shape == k.shape
                   and q_pos.shape == (t,) and k_pos.shape == (s,)
                   and h % kv == 0),
        head_dim=d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), b, t, s, h, kv, d,
            int(bool(causal)), int(window), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, NAME)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
