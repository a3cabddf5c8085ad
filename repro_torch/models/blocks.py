"""Layer dispatch (mixer + optional cross-attention + FFN) and the loop over
a stage's stacked repeats.

Port of the JAX package's ``models/blocks.py``.  A stage's parameters keep
their leading ``layers`` axis, so a JAX param tree maps onto the port leaf
for leaf; ``jax.lax.scan`` over that axis becomes a Python loop that takes
one layer's views per step.  Caches are stacked the same way, and each
layer writes its slot of them in place.

Ported layers: the attention, mLSTM and sLSTM mixers with a dense FFN or
none (xLSTM blocks carry their own projections), and the cross-attention
of encoder-decoder layers.  Mamba, MLA and MoE raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .config import LayerDef, ModelConfig, StageDef
from .layers import attention, ffn, xlstm
from .layers.common import rmsnorm, rmsnorm_init

_ROADMAP_MIXERS = "ROADMAP.md, Queue 1 item 9 (other mixers, by architecture)"
_MIXERS = ("attn", "mlstm", "slstm")
_FFNS = ("dense", "none")


@dataclass
class LayerCtx:
    """Everything a layer needs besides params/x/cache."""

    cfg: ModelConfig
    positions: torch.Tensor               # [T] int32 absolute positions
    causal: bool = True
    window: int = 0                       # sliding window (0 = full)
    pos: Optional[int] = None             # decode: current position (host)
    enc_out: Optional[torch.Tensor] = None  # encoder output for cross-attn


def check_layer(ld: LayerDef) -> None:
    """Raise for a layer kind the port does not run yet."""
    if ld.mixer not in _MIXERS:
        raise NotImplementedError(
            f"mixer {ld.mixer!r} is not ported yet: {_ROADMAP_MIXERS}")
    if ld.ffn not in _FFNS:
        raise NotImplementedError(
            f"ffn {ld.ffn!r} is not ported yet: {_ROADMAP_MIXERS}")


# --------------------------------------------------------------------------- #
# Single layer                                                                #
# --------------------------------------------------------------------------- #


def layer_init(generator: torch.Generator, ld: LayerDef, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    check_layer(ld)
    dev = generator.device
    init = {"attn": attention.attn_init, "mlstm": xlstm.mlstm_init,
            "slstm": xlstm.slstm_init}[ld.mixer]
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
         "mixer": init(generator, cfg, dtype)}
    if ld.ffn == "dense":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["ffn"] = ffn.ffn_init(generator, cfg.d_model, cfg.d_ff, dtype)
    if ld.cross_attn:
        p["norm_x"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["cross"] = attention.attn_init(generator, cfg, dtype)
    return p


def layer_cache_init(ld: LayerDef, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device, enc_len: int = 0) -> dict:
    """The mixer's cache under "self"; a cross layer's encoder K/V
    [B, enc_len, KV, hd] under "cross"."""
    check_layer(ld)
    if ld.mixer == "mlstm":
        c = {"self": xlstm.init_mlstm_cache(batch, cfg, dtype, device)}
    elif ld.mixer == "slstm":
        c = {"self": xlstm.init_slstm_cache(batch, cfg, device)}
    else:
        c = {"self": attention.init_kv_cache(
            batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
            device)}
    if ld.cross_attn:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        c["cross"] = {name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("k", "v")}
    return c


def layer_apply(
    params: dict,
    ld: LayerDef,
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, cache); a given cache is written in place.  A cross
    layer reads the encoder K/V from ``cache["cross"]`` where the cache
    holds them (decode, and prefill once it filled them), else computes
    them from ``ctx.enc_out``."""
    check_layer(ld)
    cfg = ctx.cfg
    self_cache = cache.get("self") if cache else None
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if ld.mixer == "attn":
        out, _ = attention.attn_apply(
            params["mixer"], h, cfg, positions=ctx.positions,
            causal=ctx.causal, window=ctx.window, cache=self_cache,
            pos=ctx.pos)
        out = attention.attn_out_project(params["mixer"], out)
    elif ld.mixer == "mlstm":
        out, _ = xlstm.mlstm_apply(params["mixer"], h, cfg, cache=self_cache)
    else:
        out, _ = xlstm.slstm_apply(params["mixer"], h, cfg, cache=self_cache)
    x = x + out
    if ld.cross_attn:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        ckv = cache["cross"] if cache and "cross" in cache else \
            attention.cross_kv(params["cross"], ctx.enc_out)
        x = x + attention.cross_attend(params["cross"], hx, ckv, cfg)
    if ld.ffn == "dense":
        h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
        x = x + ffn.ffn_apply(params["ffn"], h2)
    return x, cache


# --------------------------------------------------------------------------- #
# Stage (loop over repeats)                                                   #
# --------------------------------------------------------------------------- #


def _stacked(repeats: int, make) -> dict:
    """``repeats`` trees from ``make()``, called in order, stacked leaf by
    leaf along a new leading axis.  Each tree is copied into its slot as
    it is made, so at most one unstacked tree is alive: a stage's params
    or caches do not exist twice (a full-width stage is tens of GB)."""
    first = make()

    def empty(tree):
        return {k: empty(v) if isinstance(v, dict)
                else v.new_empty((repeats, *v.shape))
                for k, v in tree.items()}

    def put(dst, src, r):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, r)
            else:
                dst[k][r] = v

    out = empty(first)
    put(out, first, 0)
    del first
    for r in range(1, repeats):
        put(out, make(), r)
    return out


def take_layer(tree: dict, i: int) -> dict:
    """Views of the i-th entry along the stacked layers axis."""
    return {k: take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def stage_init(generator: torch.Generator, stage: StageDef,
               cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Stacked params: {'p0'..'pN': layer params [repeats, ...]}."""
    return {
        f"p{i}": _stacked(stage.repeats,
                          lambda ld=ld: layer_init(generator, ld, cfg, dtype))
        for i, ld in enumerate(stage.pattern)
    }


def stage_cache_init(stage: StageDef, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device, enc_len: int = 0) -> dict:
    return {
        f"p{i}": _stacked(stage.repeats,
                          lambda ld=ld: layer_cache_init(
                              ld, cfg, batch, cache_len, dtype, device,
                              enc_len))
        for i, ld in enumerate(stage.pattern)
    }


def stage_apply(
    params: dict,
    stage: StageDef,
    x: torch.Tensor,
    ctx: LayerCtx,
    caches: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Loop over stage.repeats; inside, the (short) pattern.  Returns
    (x, caches); given caches are written in place."""
    for r in range(stage.repeats):
        for i, ld in enumerate(stage.pattern):
            c = take_layer(caches[f"p{i}"], r) if caches is not None else None
            x, _ = layer_apply(take_layer(params[f"p{i}"], r), ld, x, ctx, c)
    return x, caches
