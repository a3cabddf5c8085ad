"""Layer dispatch (mixer + FFN) and the loop over a stage's stacked repeats.

Port of the JAX package's ``models/blocks.py``.  A stage's parameters keep
their leading ``layers`` axis, so a JAX param tree maps onto the port leaf
for leaf; ``jax.lax.scan`` over that axis becomes a Python loop that takes
one layer's views per step.  Caches are stacked the same way, and each
layer writes its slot of them in place.

Only the dense decoder layer is ported (attention mixer, dense FFN, no
cross-attention); any other layer raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .config import LayerDef, ModelConfig, StageDef
from .layers import attention, ffn
from .layers.common import rmsnorm, rmsnorm_init

_ROADMAP_MIXERS = "ROADMAP.md, Queue 1 item 10 (other mixers, by architecture)"


@dataclass
class LayerCtx:
    """Everything a layer needs besides params/x/cache."""

    cfg: ModelConfig
    positions: torch.Tensor               # [T] int32 absolute positions
    causal: bool = True
    window: int = 0                       # sliding window (0 = full)
    pos: Optional[int] = None             # decode: current position (host)


def check_layer(ld: LayerDef) -> None:
    """Raise for a layer kind the port does not run yet."""
    if ld.mixer != "attn":
        raise NotImplementedError(
            f"mixer {ld.mixer!r} is not ported yet: {_ROADMAP_MIXERS}")
    if ld.ffn != "dense":
        raise NotImplementedError(
            f"ffn {ld.ffn!r} is not ported yet: {_ROADMAP_MIXERS}")
    if ld.cross_attn:
        raise NotImplementedError(
            f"cross-attention is not ported yet: {_ROADMAP_MIXERS}")


# --------------------------------------------------------------------------- #
# Single layer                                                                #
# --------------------------------------------------------------------------- #


def layer_init(generator: torch.Generator, ld: LayerDef, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    check_layer(ld)
    dev = generator.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, dev),
        "mixer": attention.attn_init(generator, cfg, dtype),
        "norm2": rmsnorm_init(cfg.d_model, dtype, dev),
        "ffn": ffn.ffn_init(generator, cfg.d_model, cfg.d_ff, dtype),
    }


def layer_cache_init(ld: LayerDef, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    check_layer(ld)
    return {"self": attention.init_kv_cache(
        batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim, dtype,
        device)}


def layer_apply(
    params: dict,
    ld: LayerDef,
    x: torch.Tensor,
    ctx: LayerCtx,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Returns (x, cache); a given cache is written in place."""
    check_layer(ld)
    cfg = ctx.cfg
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    out, _ = attention.attn_apply(
        params["mixer"], h, cfg, positions=ctx.positions, causal=ctx.causal,
        window=ctx.window, cache=cache["self"] if cache else None,
        pos=ctx.pos)
    x = x + attention.attn_out_project(params["mixer"], out)
    h2 = rmsnorm(params["norm2"], x, cfg.norm_eps)
    return x + ffn.ffn_apply(params["ffn"], h2), cache


# --------------------------------------------------------------------------- #
# Stage (loop over repeats)                                                   #
# --------------------------------------------------------------------------- #


def _stack(trees: list[dict]) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def take_layer(tree: dict, i: int) -> dict:
    """Views of the i-th entry along the stacked layers axis."""
    return {k: take_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def stage_init(generator: torch.Generator, stage: StageDef,
               cfg: ModelConfig, dtype: torch.dtype) -> dict:
    """Stacked params: {'p0'..'pN': layer params [repeats, ...]}."""
    return {
        f"p{i}": _stack([layer_init(generator, ld, cfg, dtype)
                         for _ in range(stage.repeats)])
        for i, ld in enumerate(stage.pattern)
    }


def stage_cache_init(stage: StageDef, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    return {
        f"p{i}": _stack([layer_cache_init(ld, cfg, batch, cache_len, dtype,
                                          device)
                         for _ in range(stage.repeats)])
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
