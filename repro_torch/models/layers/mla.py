"""Multi-head Latent Attention (DeepSeek-V2 arXiv:2405.04434, V3 2412.19437).

Port of the JAX package's ``models/layers/mla.py``.  KV is compressed into
a rank-``kv_lora_rank`` latent ``c_kv`` plus one RoPE key ``k_rope`` shared
by the heads; only those are cached, with the int32 slot positions of the
attention cache (-1 = empty).

Prefill runs the expanded form on the flash kernel: q = [q_nope, q_rope],
k = [k_nope, k_rope broadcast over the heads], head dim nope + rope (192 at
full width), so the kernel's 1/sqrt(D) is MLA's (nope + rope)^-0.5; V is
zero-padded from ``v_head_dim`` to that width and the padded output columns
dropped.  Decode runs the absorbed form in plain products, as the JAX layer
does: W_uk folded into the query and W_uv into the output, one latent head
of width kv_rank + rope shared by every query head over the compressed
cache.  A decode token writes its slot in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels.flash_attention import flash_attention
from ..config import ModelConfig
from .attention import _project, _write_token
from .common import apply_rope, dense_init, masked_softmax, pad_last, \
    reshape, rmsnorm, rmsnorm_axes, rmsnorm_init, rope_cos_sin


def mla_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    dev = generator.device
    p: dict = {}
    if m.q_lora_rank:
        p["wdq"] = dense_init(generator, d, m.q_lora_rank, dtype=dtype)
        p["q_norm"] = rmsnorm_init(m.q_lora_rank, dtype, dev)
        p["wuq"] = dense_init(generator, m.q_lora_rank, h, qd, dtype=dtype)
    else:
        p["wq"] = dense_init(generator, d, h, qd, dtype=dtype)
    p["wdkv"] = dense_init(generator, d, m.kv_lora_rank + m.rope_head_dim,
                           dtype=dtype)
    p["kv_norm"] = rmsnorm_init(m.kv_lora_rank, dtype, dev)
    p["wuk"] = dense_init(generator, m.kv_lora_rank, h, m.nope_head_dim,
                          dtype=dtype)
    p["wuv"] = dense_init(generator, m.kv_lora_rank, h, m.v_head_dim,
                          dtype=dtype)
    p["wo"] = dense_init(generator, h * m.v_head_dim, d, dtype=dtype)
    return p


def mla_axes(cfg: ModelConfig) -> dict:
    a: dict = {}
    if cfg.mla.q_lora_rank:
        a["wdq"] = ("embed", "q_rank")
        a["q_norm"] = rmsnorm_axes("q_rank")
        a["wuq"] = ("q_rank", "heads", "head_dim")
    else:
        a["wq"] = ("embed", "heads", "head_dim")
    a["wdkv"] = ("embed", "kv_rank_rope")
    a["kv_norm"] = rmsnorm_axes("kv_rank")
    a["wuk"] = ("kv_rank", "heads", "head_dim")
    a["wuv"] = ("kv_rank", "heads", "head_dim")
    a["wo"] = ("heads_flat", "embed")
    return a


def init_mla_cache(batch: int, length: int, cfg: ModelConfig,
                   dtype: torch.dtype, device: torch.device) -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, length, m.rope_head_dim), dtype=dtype,
                              device=device),
        "positions": torch.full((batch, length), -1, dtype=torch.int32,
                                device=device),
    }


def mla_cache_axes() -> dict:
    return {
        "c_kv": ("batch", "cache", "kv_rank"),
        "k_rope": ("batch", "cache", "rope_dim"),
        "positions": ("batch", "cache"),
    }


def _queries(params: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    """-> (q_nope [B,T,H,nd], q_rope [B,T,H,rd] rotated)."""
    m = cfg.mla
    if "wdq" in params:
        cq = rmsnorm(params["q_norm"], torch.matmul(x, params["wdq"]),
                     cfg.norm_eps)
        q = _project(cq, params["wuq"], None)
    else:
        q = _project(x, params["wq"], None)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    cos, sin = rope_cos_sin(positions, m.rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _compress(params: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor):
    """-> (c_kv [B,S,R] normalised, k_rope [B,S,rd] rotated): what the
    cache holds."""
    m = cfg.mla
    dkv = torch.matmul(x, params["wdkv"])
    c_kv = rmsnorm(params["kv_norm"], dkv[..., :m.kv_lora_rank],
                   cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, m.rope_head_dim, cfg.rope_theta)
    k_rope = apply_rope(dkv[..., None, m.kv_lora_rank:], cos, sin)[..., 0, :]
    return c_kv, k_rope


def mla_apply(
    params: dict,
    x: torch.Tensor,                    # [B, T, d]
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,            # [T] int32 absolute positions
    window: int = 0,
    cache: Optional[dict] = None,       # decode: attend over the latents
    pos: Optional[int] = None,          # decode: current position, host int
) -> tuple[torch.Tensor, Optional[dict]]:
    """-> (output [B, T, d], cache written in place or None)."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    q_nope, q_rope = _queries(params, x, cfg, positions)

    if cache is None:
        # ---- expanded prefill form, on the flash kernel ------------------ #
        if vd > nd + rd:
            raise ValueError(f"MLA v_head_dim {vd} exceeds the query/key "
                             f"width {nd + rd}")
        c_kv, k_rope = _compress(params, x, cfg, positions)
        k_nope = _project(c_kv, params["wuk"], None)
        v = _project(c_kv, params["wuv"], None)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, rd)],
                      dim=-1)
        v = pad_last(v, nd + rd - vd)
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              positions, positions, causal=True,
                              window=window)[..., :vd]
        return torch.matmul(reshape(out, b, t, h * vd), params["wo"]), None

    # ---- absorbed decode form (T == 1) ----------------------------------- #
    if t != 1 or pos is None:
        raise ValueError("cache decode takes one token and its position "
                         f"(got T={t}, pos={pos})")
    c_new, kr_new = _compress(params, x, cfg, positions)
    _write_token(cache, pos, window, c_kv=c_new, k_rope=kr_new)
    c_kv, k_rope, stored = cache["c_kv"], cache["k_rope"], cache["positions"]
    scale = (nd + rd) ** -0.5
    q_abs = torch.einsum("bthk,rhk->bthr", q_nope, params["wuk"])
    scores = (torch.einsum("bthr,bsr->bhts", q_abs, c_kv)
              + torch.einsum("bthk,bsk->bhts", q_rope, k_rope)) * scale
    valid = (stored >= 0) & (stored <= pos)
    if window > 0:
        valid &= stored > pos - window
    w = masked_softmax(scores, valid[:, None, None, :])
    ctx = torch.einsum("bhts,bsr->bthr", w.to(c_kv.dtype), c_kv)
    out = torch.einsum("bthr,rhk->bthk", ctx, params["wuv"])
    return torch.matmul(reshape(out, b, t, h * vd), params["wo"]), cache
