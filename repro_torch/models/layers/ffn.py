"""Dense SwiGLU FFN and Mixture-of-Experts with capacity-based dispatch.

Port of the JAX package's ``models/layers/ffn.py``.  MoE follows the
GShard/Switch group-wise dispatch: tokens are split into groups of
``group_size`` (the token count zero-padded to a multiple of it); each group
routes top-k with per-group expert capacity
C = max(1, int(k * group_size / E * capacity_factor + 0.9999)), computed on
the host.  A token's slot in an expert's buffer is the running count over the
flattened (token, k) order; tokens past C fall through to the residual (plus
the shared experts where there are any).  Dispatch and combine are products
with a [G, T, E, C] one-hot, and every expert's weights take part in every
call, as in the JAX layer.

Routers: "softmax" (classic) or "sigmoid" (DeepSeek-V3 style scores), each
with top-k renormalisation; the router's logits are computed in the
activations' dtype and routed in f32.
"""
from __future__ import annotations

import functools

import torch

from ...kernels import _shard
from ..config import ModelConfig, MoEConfig
from .common import dense_init, normal_init, swiglu

# --------------------------------------------------------------------------- #
# Dense FFN                                                                   #
# --------------------------------------------------------------------------- #


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "wg": dense_init(generator, d_model, d_ff, dtype=dtype),
        "wu": dense_init(generator, d_model, d_ff, dtype=dtype),
        "wd": dense_init(generator, d_ff, d_model, dtype=dtype),
    }


def ffn_axes() -> dict:
    return {"wg": ("embed", "ff"), "wu": ("embed", "ff"),
            "wd": ("ff", "embed")}


def ffn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.matmul(x, params["wg"])
    up = torch.matmul(x, params["wu"])
    return torch.matmul(swiglu(gate, up), params["wd"])


# --------------------------------------------------------------------------- #
# MoE                                                                         #
# --------------------------------------------------------------------------- #


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """The JAX tree: ``router`` [d, E] in f32 whatever ``dtype`` is, expert
    weights wg/wu [E, d, f] and wd [E, f, d], and the shared experts as one
    dense FFN of width ``n_shared * d_expert``."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    p = {
        "router": dense_init(generator, d, e, dtype=torch.float32),
        "wg": normal_init(generator, (e, d, f), d ** -0.5, dtype),
        "wu": normal_init(generator, (e, d, f), d ** -0.5, dtype),
        "wd": normal_init(generator, (e, f, d), f ** -0.5, dtype),
    }
    if m.n_shared:
        p["shared"] = ffn_init(generator, d, m.d_expert * m.n_shared, dtype)
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    a = {
        "router": ("embed", "experts"),
        "wg": ("experts", "embed", "expert_ff"),
        "wu": ("experts", "embed", "expert_ff"),
        "wd": ("experts", "expert_ff", "embed"),
    }
    if cfg.moe.n_shared:
        a["shared"] = ffn_axes()
    return a


def _top_k(scores: torch.Tensor, k: int):
    """Top k of the last axis, the lower index first among equal scores, as
    ``jax.lax.top_k`` orders them.  ``torch.topk`` documents no order among
    equal values on either device (its CPU and CUDA implementations select
    by different algorithms), so the port sorts stably instead."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(m: MoEConfig, logits: torch.Tensor):
    """logits [..., E] f32 -> (topk_weight [..., k], topk_idx [..., k],
    probs [..., E])."""
    if m.router == "sigmoid":
        scores = torch.sigmoid(logits)
        w, idx = _top_k(scores, m.top_k)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
        probs = scores / (scores.sum(dim=-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, m.top_k)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
    return w, idx, probs


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over n classes; an index outside 0..n-1 gives
    an all-zero row, as ``jax.nn.one_hot`` does (``F.one_hot`` raises on
    the CPU and asserts on the card)."""
    classes = torch.arange(n, device=idx.device)
    return (idx[..., None] == classes).float()


def _dispatch(m: MoEConfig, logits: torch.Tensor, cap: int):
    """Router logits [g, t, E] f32 -> (dispatch [g,t,E,C], combine
    [g,t,E,C], the tokens' expert load [g,t,E], probs [g,t,E]), all f32.
    A DTensor's shards run it with the groups as they are sharded and the
    rest gathered (DTensor has no sharding rule that keeps the top k, the
    running count and the one-hots apart)."""
    if _shard.is_dtensor(logits):
        dims = (0, None)
        return _shard.local_call(functools.partial(_dispatch, m, cap=cap),
                                 (logits,), (dims,), (dims,) * 4)
    g, g_sz, e = logits.shape
    k = m.top_k
    weights, idx, probs = _route(m, logits)
    onehot = _one_hot(idx, e)                               # [g,t,k,E]
    # slot of each (token, k) in its expert's buffer: the running count
    pos = torch.cumsum(onehot.reshape(g, g_sz * k, e), dim=1) - 1.0
    pos = pos.reshape(g, g_sz, k, e)
    kept = onehot * ((pos < cap) & (onehot > 0))
    pos_oh = _one_hot(pos.to(torch.int32), cap)             # [g,t,k,E,C]
    # an expert appears at most once in a token's top k, so each sum over
    # k below has at most one nonzero term
    dispatch = (kept[..., None] * pos_oh).sum(dim=2)        # [g,t,E,C]
    combine = (weights[..., None, None] * kept[..., None] * pos_oh).sum(dim=2)
    load = onehot[..., 0, :] if k == 1 else onehot.sum(dim=2)
    return dispatch, combine, load, probs


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              group_size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> (y [B, T, d], Switch load-balance aux loss, an f32
    scalar)."""
    m = cfg.moe
    b, t, d = x.shape
    n_tok = b * t
    g_sz = min(group_size, n_tok)
    n_pad = (-n_tok) % g_sz
    flat = x.reshape(n_tok, d)
    if n_pad:
        flat = torch.cat([flat, flat.new_zeros((n_pad, d))], dim=0)
    g = flat.shape[0] // g_sz
    xg = flat.reshape(g, g_sz, d)

    logits = torch.matmul(xg, params["router"].to(xg.dtype))
    e, k = m.n_experts, m.top_k
    cap = max(1, int(k * g_sz / e * m.capacity_factor + 0.9999))
    dispatch, combine, load, probs = _dispatch(m, logits.float(), cap)

    # xe [E, g*C, d]: every (expert, slot) row holds at most one token
    xe = torch.matmul(dispatch.to(xg.dtype).reshape(g, g_sz, e * cap)
                      .transpose(1, 2), xg)                 # [g, E*C, d]
    xe = xe.reshape(g, e, cap, d).transpose(0, 1).reshape(e, g * cap, d)
    h = swiglu(torch.matmul(xe, params["wg"]), torch.matmul(xe, params["wu"]))
    ye = torch.matmul(h, params["wd"])                      # [E, g*C, d]
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)
    y = torch.matmul(combine.to(xg.dtype).reshape(g, g_sz, e * cap), ye)
    y = y.reshape(-1, d)[:n_tok].reshape(b, t, d)

    # Switch-style load balance aux loss: E * sum_e f_e * p_e
    frac = load.mean(dim=(0, 1)) / k
    pmean = probs.mean(dim=(0, 1))
    aux = e * (frac * pmean).sum() * m.router_aux_weight

    if m.n_shared:
        y = y + ffn_apply(params["shared"], x)
    return y, aux
