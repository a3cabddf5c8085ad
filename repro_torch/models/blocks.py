"""Layer dispatch (mixer + optional cross-attention + FFN) and the loop over
a stage's stacked repeats.

Port of the JAX package's ``models/blocks.py``.  A stage's parameters keep
their leading ``layers`` axis, so a JAX param tree maps onto the port leaf
for leaf; ``jax.lax.scan`` over that axis becomes a Python loop that takes
one layer's views per step.  Caches are stacked the same way, and each
layer writes its slot of them in place.

Mixers: attention, MLA, Mamba, mLSTM and sLSTM; FFNs: dense, MoE or none
(xLSTM blocks carry their own projections); cross-attention for the
decoder layers of an encoder-decoder.  A layer returns the MoE aux loss
beside its output, as the JAX one does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import _shard
from .config import LayerDef, ModelConfig, StageDef
from .layers import attention, ffn, mamba, mla, xlstm
from .layers.common import draws_into, rmsnorm, rmsnorm_axes, rmsnorm_init


@dataclass
class LayerCtx:
    """Everything a layer needs besides params/x/cache."""

    cfg: ModelConfig
    positions: torch.Tensor               # [T] int32 absolute positions
    causal: bool = True
    window: int = 0                       # sliding window (0 = full)
    pos: Optional[int | torch.Tensor] = None  # decode: current position,
    #                                             host int or 0-d int32 tensor
    enc_out: Optional[torch.Tensor] = None  # encoder output for cross-attn
    moe_group_size: int = 256


# --------------------------------------------------------------------------- #
# Single layer                                                                #
# --------------------------------------------------------------------------- #


_MIXER_INIT = {
    "attn": attention.attn_init,
    "mla": mla.mla_init,
    "mamba": mamba.mamba_init,
    "mlstm": xlstm.mlstm_init,
    "slstm": xlstm.slstm_init,
}
_MIXER_AXES = {
    "attn": attention.attn_axes,
    "mla": mla.mla_axes,
    "mamba": mamba.mamba_axes,
    "mlstm": xlstm.mlstm_axes,
    "slstm": xlstm.slstm_axes,
}
_MIXER_CACHE_AXES = {
    "attn": attention.kv_cache_axes,
    "mla": mla.mla_cache_axes,
    "mamba": mamba.mamba_cache_axes,
    "mlstm": xlstm.mlstm_cache_axes,
    "slstm": xlstm.slstm_cache_axes,
}


def layer_init(generator: torch.Generator, ld: LayerDef, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    if ld.mixer not in _MIXER_INIT:
        raise ValueError(f"unknown mixer {ld.mixer!r}")
    dev = generator.device
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, dev),
         "mixer": _MIXER_INIT[ld.mixer](generator, cfg, dtype)}
    if ld.ffn != "none":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, dev)
        if ld.ffn == "dense":
            p["ffn"] = ffn.ffn_init(generator, cfg.d_model, cfg.d_ff, dtype)
        else:
            p["ffn"] = ffn.moe_init(generator, cfg, dtype)
    if ld.cross_attn:
        p["norm_x"] = rmsnorm_init(cfg.d_model, dtype, dev)
        p["cross"] = attention.attn_init(generator, cfg, dtype)
    return p


def layer_axes(ld: LayerDef, cfg: ModelConfig) -> dict:
    """The logical axes of :func:`layer_init`'s tree, leaf for leaf."""
    a: dict = {
        "norm1": rmsnorm_axes(),
        "mixer": _MIXER_AXES[ld.mixer](cfg),
    }
    if ld.ffn != "none":
        a["norm2"] = rmsnorm_axes()
        a["ffn"] = ffn.ffn_axes() if ld.ffn == "dense" else ffn.moe_axes(cfg)
    if ld.cross_attn:
        a["norm_x"] = rmsnorm_axes()
        a["cross"] = attention.attn_axes(cfg)
    return a


def layer_cache_init(ld: LayerDef, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device, enc_len: int = 0) -> dict:
    """The mixer's cache under "self" (attention: K/V slots; MLA: the
    latents ``c_kv``, ``k_rope`` and their slot positions; Mamba: the conv
    window and SSM state; xLSTM: its recurrent state); a cross layer's
    encoder K/V [B, enc_len, KV, hd] under "cross"."""
    if ld.mixer == "attn":
        self_cache = attention.init_kv_cache(
            batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
            device)
    elif ld.mixer == "mla":
        self_cache = mla.init_mla_cache(batch, cache_len, cfg, dtype, device)
    elif ld.mixer == "mamba":
        self_cache = mamba.init_mamba_cache(batch, cfg, dtype, device)
    elif ld.mixer == "mlstm":
        self_cache = xlstm.init_mlstm_cache(batch, cfg, dtype, device)
    elif ld.mixer == "slstm":
        self_cache = xlstm.init_slstm_cache(batch, cfg, device)
    else:
        raise ValueError(f"unknown mixer {ld.mixer!r}")
    c = {"self": self_cache}
    if ld.cross_attn:
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        c["cross"] = {name: torch.zeros(shape, dtype=dtype, device=device)
                      for name in ("k", "v")}
    return c


def layer_cache_axes(ld: LayerDef) -> dict:
    c: dict = {"self": _MIXER_CACHE_AXES[ld.mixer]()}
    if ld.cross_attn:
        c["cross"] = {
            "k": ("batch", "cache", "kv_heads", "head_dim"),
            "v": ("batch", "cache", "kv_heads", "head_dim"),
        }
    return c


def layer_apply(
    params: dict,
    ld: LayerDef,
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor | float]:
    """Returns (x, cache, aux); a given cache is written in place.  ``aux``
    is the MoE layer's load-balance loss (an f32 scalar tensor), 0.0 for a
    layer without one.  A cross layer reads the encoder K/V from
    ``cache["cross"]`` where the cache holds them (decode, and prefill once
    it filled them), else computes them from ``ctx.enc_out``."""
    cfg = ctx.cfg
    self_cache = cache.get("self") if cache else None
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    if ld.mixer == "attn":
        out, _ = attention.attn_apply(
            params["mixer"], h, cfg, positions=ctx.positions,
            causal=ctx.causal, window=ctx.window, cache=self_cache,
            pos=ctx.pos)
        out = attention.attn_out_project(params["mixer"], out)
    elif ld.mixer == "mla":
        out, _ = mla.mla_apply(params["mixer"], h, cfg,
                               positions=ctx.positions, window=ctx.window,
                               cache=self_cache, pos=ctx.pos)
    elif ld.mixer == "mamba":
        out, _ = mamba.mamba_apply(params["mixer"], h, cfg, cache=self_cache)
    elif ld.mixer == "mlstm":
        out, _ = xlstm.mlstm_apply(params["mixer"], h, cfg, cache=self_cache)
    elif ld.mixer == "slstm":
        out, _ = xlstm.slstm_apply(params["mixer"], h, cfg, cache=self_cache)
    else:
        raise ValueError(f"unknown mixer {ld.mixer!r}")
    x = x + out
    if ld.cross_attn:
        hx = rmsnorm(params["norm_x"], x, cfg.norm_eps)
        ckv = cache["cross"] if cache and "cross" in cache else \
            attention.cross_kv(params["cross"], ctx.enc_out)
        x = x + attention.cross_attend(params["cross"], hx, ckv, cfg)
    aux = 0.0
    if ld.ffn != "none":
        h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
        if ld.ffn == "dense":
            x = x + ffn.ffn_apply(params["ffn"], h2)
        else:
            y, aux = ffn.moe_apply(params["ffn"], h2, cfg,
                                   group_size=ctx.moe_group_size)
            x = x + y
    return x, cache, aux


# --------------------------------------------------------------------------- #
# Stage (loop over repeats)                                                   #
# --------------------------------------------------------------------------- #


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _stacked(repeats: int, make, device: torch.device) -> dict:
    """``repeats`` trees from ``make()``, called in order, stacked leaf by
    leaf along a new leading axis, without a second copy of any layer (a
    full-width MoE layer is tens of GB).  One repeat: the tree itself,
    viewed with a leading axis of 1.  More: a dry run of ``make`` (no draw,
    meta tensors: ``common.draws_into``) gives the shapes; then each repeat
    draws every random leaf straight into its slot, ``normal_init`` being
    called in the same order every time, and its other leaves (norm scales,
    biases, caches) are copied in."""
    if repeats == 1:
        return _map(make(), lambda v: v.unsqueeze(0))
    drawn: list = []
    with draws_into(record=drawn, dry=True):
        shapes = make()
    out = _map(shapes, lambda v: torch.empty((repeats, *v.shape),
                                             dtype=v.dtype, device=device))
    if device.type == "meta":                # an abstract tree: shapes only
        return out
    where = {id(a): b for a, b in zip(_leaves(shapes), _leaves(out))}
    if any(id(t) not in where for t in drawn):
        raise RuntimeError("a layer's random leaf is not a normal_init draw "
                           "as it is; it cannot be drawn into its slot")
    stacked = [where[id(t)] for t in drawn]
    del shapes, drawn, where

    def put(dst, src, r):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, r)
            elif v.data_ptr() != dst[k][r].data_ptr():   # not drawn there
                dst[k][r] = v

    for r in range(repeats):
        with draws_into(slots=[t[r] for t in stacked]):
            put(out, make(), r)
    return out


def take_layer(tree: dict, i: int) -> dict:
    """Views of the i-th entry along the stacked layers axis."""
    return {k: take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_params(tree: dict, i: int) -> dict:
    """The i-th layer's params: views of ``tree``; DTensor weights are
    gathered over the data-parallel mesh axes first (FSDP), their
    tensor-parallel shards kept."""
    layer = take_layer(tree, i)
    if not _shard.is_dtensor(next(_leaves(tree))):
        return layer
    return _map(layer, _shard.unshard)


def stage_init(generator: torch.Generator, stage: StageDef,
               cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Stacked params: {'p0'..'pN': layer params [repeats, ...]}."""
    return {
        f"p{i}": _stacked(stage.repeats,
                          lambda ld=ld: layer_init(generator, ld, cfg, dtype),
                          generator.device)
        for i, ld in enumerate(stage.pattern)
    }


def _prepend_layers(tree: dict) -> dict:
    return _map(tree, lambda ax: ("layers",) + ax)


def stage_axes(stage: StageDef, cfg: ModelConfig) -> dict:
    return {f"p{i}": _prepend_layers(layer_axes(ld, cfg))
            for i, ld in enumerate(stage.pattern)}


def stage_cache_init(stage: StageDef, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device, enc_len: int = 0) -> dict:
    return {
        f"p{i}": _stacked(stage.repeats,
                          lambda ld=ld: layer_cache_init(
                              ld, cfg, batch, cache_len, dtype, device,
                              enc_len), device)
        for i, ld in enumerate(stage.pattern)
    }


def stage_cache_axes(stage: StageDef) -> dict:
    return {f"p{i}": _prepend_layers(layer_cache_axes(ld))
            for i, ld in enumerate(stage.pattern)}


def stage_apply(
    params: dict,
    stage: StageDef,
    x: torch.Tensor,
    ctx: LayerCtx,
    caches: Optional[dict] = None,
    remat: bool = False,
) -> tuple[torch.Tensor, Optional[dict], torch.Tensor | float]:
    """Loop over stage.repeats; inside, the (short) pattern.  Returns
    (x, caches, summed aux loss); given caches are written in place.

    ``remat``: each repeat's body runs under ``torch.utils.checkpoint``
    (non-reentrant), as the JAX stage wraps its scan body in
    ``jax.checkpoint``: the backward recomputes the repeat's activations
    from its input instead of keeping them."""
    def body(x, r):
        aux = 0.0
        for i, ld in enumerate(stage.pattern):
            c = take_layer(caches[f"p{i}"], r) if caches is not None else None
            x, _, a = layer_apply(layer_params(params[f"p{i}"], r), ld, x,
                                  ctx, c)
            x = _shard.settle(x)
            aux = aux + a
        return x, aux

    aux = 0.0
    for r in range(stage.repeats):
        if remat:
            x, a = checkpoint(body, x, r, use_reentrant=False)
        else:
            x, a = body(x, r)
        aux = aux + a
    return x, caches, aux
