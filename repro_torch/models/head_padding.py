"""Head padding so attention heads divide the mesh's model axis.

Port of the JAX package's ``models/head_padding.py``.  Several
architectures have head counts that do not divide a model axis of 16
(llava 56q/8kv, qwen2 14q/2kv, smollm 9q/3kv), so the divisibility rules of
``models/sharding.py`` replicate their attention weights and KV caches.
Padding the head axes makes them divide it:

  kv' = lcm(n_kv_heads, multiple)      (each kv head copied r = kv'/kv times)
  g   = n_heads // n_kv_heads          (the GQA group)
  g'  = ceil(g / r)                    (queries per padded kv slot)
  h'  = kv' * g'

Padded kv slot ``j`` holds a copy of kv head ``j // r``; its query slots
``l in [0, g')`` hold query head ``(j//r)*g + (j%r)*g' + l``, or zero
weights where that index walks off the group.  A zero query row attends
uniformly, and the zero rows of the output projection that match it drop
what it read, so the padded model computes what the unpadded one does.

``pad_heads_config`` transforms the config, ``pad_attn_params`` a param
tree of tensors (an unpadded checkpoint served padded).
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

from .config import ModelConfig


def padded_head_counts(n_heads: int, n_kv_heads: int,
                       multiple: int) -> tuple[int, int]:
    """(h', kv') after padding so ``multiple | kv'`` and ``multiple | h'``."""
    kv_p = math.lcm(n_kv_heads, multiple)
    r = kv_p // n_kv_heads
    g = n_heads // n_kv_heads
    g_p = -(-g // r)                     # ceil
    return kv_p * g_p, kv_p


def pad_heads_config(cfg: ModelConfig, multiple: int) -> ModelConfig:
    """Padded-head variant of ``cfg`` (``cfg`` itself where the heads
    already divide, for MLA, whose one latent cache has no kv heads, and
    where the query heads are not whole GQA groups)."""
    if cfg.mla is not None:
        return cfg
    if cfg.n_heads % multiple == 0 and cfg.n_kv_heads % multiple == 0:
        return cfg
    if cfg.n_heads % cfg.n_kv_heads != 0:
        return cfg
    h_p, kv_p = padded_head_counts(cfg.n_heads, cfg.n_kv_heads, multiple)
    return replace(cfg, n_heads=h_p, n_kv_heads=kv_p,
                   head_dim=cfg.resolved_head_dim)


def _q_slot_map(h: int, kv: int, h_p: int, kv_p: int) -> list[int]:
    """padded q slot -> original q head index (or -1 for a zero slot)."""
    r = kv_p // kv
    g = h // kv
    g_p = h_p // kv_p
    out = []
    for j in range(kv_p):
        i, c = divmod(j, r)
        for l in range(g_p):
            src = c * g_p + l
            out.append(i * g + src if src < g else -1)
    return out


def _take_heads(w: torch.Tensor, qmap: list[int], dim: int) -> torch.Tensor:
    """``w`` with its head axis ``dim`` replaced by the heads of ``qmap``,
    zeros where it is -1 (a gather from ``w`` with a zero head appended)."""
    zero = torch.zeros_like(w.narrow(dim, 0, 1))
    src = torch.tensor([s if s >= 0 else w.shape[dim] for s in qmap],
                       device=w.device)
    return torch.cat([w, zero], dim=dim).index_select(dim, src)


def _pad_attn_leaf_dict(p: dict, h: int, kv: int, h_p: int, kv_p: int,
                        hd: int) -> dict:
    """Pad one attention param dict {wq, wk, wv, wo[, bq, bk, bv]}.

    Leading (stacked-layer) axes are kept; head axes are addressed from the
    right."""
    r = kv_p // kv
    qmap = _q_slot_map(h, kv, h_p, kv_p)
    out = dict(p)
    out["wq"] = _take_heads(p["wq"], qmap, p["wq"].dim() - 2)
    out["wk"] = p["wk"].repeat_interleave(r, dim=-2)
    out["wv"] = p["wv"].repeat_interleave(r, dim=-2)
    # wo [..., h*hd, d] -> [..., h, hd, d], rows placed per qmap, reflattened
    wo = p["wo"]
    wo_h = wo.reshape(*wo.shape[:-2], h, hd, wo.shape[-1])
    out["wo"] = _take_heads(wo_h, qmap, wo_h.dim() - 3).reshape(
        *wo.shape[:-2], h_p * hd, wo.shape[-1])
    if "bq" in p:
        out["bq"] = _take_heads(p["bq"], qmap, p["bq"].dim() - 2)
        out["bk"] = p["bk"].repeat_interleave(r, dim=-2)
        out["bv"] = p["bv"].repeat_interleave(r, dim=-2)
    return out


def pad_attn_params(params: dict, cfg: ModelConfig,
                    cfg_p: ModelConfig) -> dict:
    """An unpadded param tree in the padded-head layout of ``cfg_p`` (new
    tensors for the attention leaves; every other leaf is shared)."""
    if cfg_p.n_heads == cfg.n_heads and cfg_p.n_kv_heads == cfg.n_kv_heads:
        return params
    h, kv = cfg.n_heads, cfg.n_kv_heads
    h_p, kv_p = cfg_p.n_heads, cfg_p.n_kv_heads
    hd = cfg.resolved_head_dim
    out = dict(params)

    def visit(stage_params, stage):
        sp = dict(stage_params)
        for i, ld in enumerate(stage.pattern):
            lp = dict(sp[f"p{i}"])
            if ld.mixer == "attn":
                lp["mixer"] = _pad_attn_leaf_dict(lp["mixer"], h, kv, h_p,
                                                  kv_p, hd)
            if ld.cross_attn:
                lp["cross"] = _pad_attn_leaf_dict(lp["cross"], h, kv, h_p,
                                                  kv_p, hd)
            sp[f"p{i}"] = lp
        return sp

    for i, st in enumerate(cfg.stages):
        out[f"dec{i}"] = visit(out[f"dec{i}"], st)
    for i, st in enumerate(cfg.encoder_stages):
        if f"enc{i}" in out:
            out[f"enc{i}"] = visit(out[f"enc{i}"], st)
    return out
