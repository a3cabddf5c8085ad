"""GQA/MHA attention with RoPE, optional QKV bias, sliding windows and a
position-tracked (optionally rotating) KV cache.

Port of the JAX package's ``models/layers/attention.py`` (self-attention;
cross-attention waits for the encoder-decoder port).  Cache layout: k/v
[B, S, KV, D] with an int32 ``positions [B, S]`` slot map (-1 = empty).
Full causal caches write slot ``pos``; sliding-window caches write slot
``pos % cache_len``.  Masks come from the stored absolute positions, never
from slot order.

Full-sequence attention goes through the flash kernel and cache decode
through the decode kernel; both wrappers take their plain versions for CPU
tensors.  Unlike the JAX layer, a decode step writes its new K/V slot into
the cache tensors in place instead of returning updated copies: a cache is
owned by one request, and the copy would cost a full cache write per token.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels.decode_attention import decode_attention
from ...kernels.flash_attention import flash_attention, gqa_attention_ref
from ..config import ModelConfig
from .common import apply_rope, dense_init, rope_cos_sin

# The model's GQA attention over an explicit mask [B|1, 1, T, S]: the plain
# version the kernels are held against (math in f32).
_gqa_scores_to_out = gqa_attention_ref


# --------------------------------------------------------------------------- #
# Params                                                                      #
# --------------------------------------------------------------------------- #


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, d, cfg.n_heads, hd, dtype=dtype),
        "wk": dense_init(generator, d, cfg.n_kv_heads, hd, dtype=dtype),
        "wv": dense_init(generator, d, cfg.n_kv_heads, hd, dtype=dtype),
        "wo": dense_init(generator, cfg.n_heads * hd, d, dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
    return p


# --------------------------------------------------------------------------- #
# KV cache                                                                    #
# --------------------------------------------------------------------------- #


def init_kv_cache(batch: int, length: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "k": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                         device=device),
        "positions": torch.full((batch, length), -1, dtype=torch.int32,
                                device=device),
    }


def _write_slot(cache_len: int, pos: int, window: int) -> int:
    """The slot a decode token writes.  Clamped into the cache like
    ``jax.lax.dynamic_update_slice``: with no window and ``pos >= cache_len``
    the last slot is overwritten."""
    slot = pos % cache_len if window > 0 else pos
    return min(max(slot, 0), cache_len - 1)


# --------------------------------------------------------------------------- #
# Core attention                                                              #
# --------------------------------------------------------------------------- #


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                window: int) -> torch.Tensor:
    """q_pos [T], k_pos [S] (absolute) -> [T, S] bool."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _project(x: torch.Tensor, w: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, T, d] @ w [d, N, hd] (+ b [N, hd]) -> [B, T, N, hd]."""
    bsz, t, d = x.shape
    out = torch.matmul(x, w.reshape(d, -1)).view(bsz, t, *w.shape[1:])
    return out if b is None else out + b


def project_kv(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """K (with RoPE at ``positions``) and V of x -> [B, T, KV, hd] each."""
    k = _project(x, params["wk"], params.get("bk"))
    v = _project(x, params["wv"], params.get("bv"))
    cos, sin = rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def attn_apply(
    params: dict,
    x: torch.Tensor,                    # [B, T, d]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,            # [T] int32 absolute positions
    causal: bool = True,
    window: int = 0,
    cache: Optional[dict] = None,       # decode: attend over cache
    pos: Optional[int] = None,          # decode: current position, host int
) -> tuple[torch.Tensor, Optional[dict]]:
    """-> (attention output [B, T, H, hd], cache written in place or None)."""
    hd = cfg.resolved_head_dim
    q = _project(x, params["wq"], params.get("bq"))
    cos_q, sin_q = rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos_q, sin_q)

    if cache is None:
        k, v = project_kv(params, x, positions, cfg)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              positions, positions, causal=causal,
                              window=window)
        return out, None

    # ---- decode against the cache (T == 1) ------------------------------- #
    if x.shape[1] != 1 or pos is None:
        raise ValueError("cache decode takes one token and its position "
                         f"(got T={x.shape[1]}, pos={pos})")
    cache_len = cache["k"].shape[1]
    k_new, v_new = project_kv(params, x, positions, cfg)
    slot = _write_slot(cache_len, pos, window)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["positions"][:, slot] = pos
    out = decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                           cache["positions"], pos, window=window)
    return out[:, None], cache


def attn_out_project(params: dict, attn_out: torch.Tensor) -> torch.Tensor:
    b, t, h, d = attn_out.shape
    return torch.matmul(attn_out.reshape(b, t, h * d), params["wo"])
