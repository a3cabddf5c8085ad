"""The dense decoder: embeddings, decoder stages, tied or untied LM head,
with init / forward / prefill / decode_step entry points.

Port of the JAX package's ``models/model.py`` for decoder-only text models
whose layers are attention + dense FFN.  Encoder-decoder and modality
front ends raise ``NotImplementedError`` (ROADMAP.md, Queue 1 item 10).

Caches are written in place: ``prefill`` fills freshly allocated caches and
``decode_step`` writes one slot per layer into the caches it is given and
returns the same dict.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .blocks import LayerCtx, check_layer, layer_apply, stage_apply, \
    stage_cache_init, stage_init, take_layer
from .config import ModelConfig
from .layers.attention import project_kv
from .layers.common import normal_init, dense_init, rmsnorm, rmsnorm_init

Params = dict
Caches = dict


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def check_config(cfg: ModelConfig) -> None:
    """Raise for an architecture the port does not run yet."""
    if cfg.is_encoder_decoder or cfg.modality_embed_dim:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and modality front ends are not "
            "ported yet: ROADMAP.md, Queue 1 item 10")
    for st in cfg.stages:
        for ld in st.pattern:
            check_layer(ld)


# --------------------------------------------------------------------------- #
# Init                                                                        #
# --------------------------------------------------------------------------- #


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> Params:
    """Random params with the JAX package's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    check_config(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = _dtype(cfg)
    p: Params = {
        "embed": normal_init(gen, (cfg.padded_vocab, cfg.d_model), 0.02, dt),
        "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                  dtype=dt)
    for i, st in enumerate(cfg.stages):
        p[f"dec{i}"] = stage_init(gen, st, cfg, dt)
    return p


# --------------------------------------------------------------------------- #
# Embedding / head                                                            #
# --------------------------------------------------------------------------- #


def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def lm_logits(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, params["embed"].t())
    return torch.matmul(x, params["lm_head"])


def _positions(t: int, device: torch.device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device)


# --------------------------------------------------------------------------- #
# Decoder forward (full sequence)                                             #
# --------------------------------------------------------------------------- #


def forward(params: Params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch {"tokens": [B, T] int} -> logits [B, T, padded_vocab]."""
    check_config(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    ctx = LayerCtx(cfg=cfg, positions=_positions(x.shape[1], x.device),
                   causal=True, window=cfg.sliding_window)
    for i, st in enumerate(cfg.stages):
        x, _ = stage_apply(params[f"dec{i}"], st, x, ctx)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x)


# --------------------------------------------------------------------------- #
# KV caches                                                                   #
# --------------------------------------------------------------------------- #


def init_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                device: str | torch.device) -> Caches:
    dev = torch.device(device)
    return {
        f"dec{i}": stage_cache_init(st, cfg, batch, cache_len, _dtype(cfg),
                                    dev)
        for i, st in enumerate(cfg.stages)
    }


# --------------------------------------------------------------------------- #
# Prefill (fill caches with a prompt) and single-token decode                 #
# --------------------------------------------------------------------------- #


def prefill(params: Params, cfg: ModelConfig, batch: dict,
            cache_len: int) -> tuple[torch.Tensor, Caches]:
    """Runs the full prompt, returns (last-position logits [B, 1, V],
    filled caches)."""
    check_config(cfg)
    x = embed_tokens(params, cfg, batch["tokens"])
    b, t, _ = x.shape
    ctx = LayerCtx(cfg=cfg, positions=_positions(t, x.device), causal=True,
                   window=cfg.sliding_window)
    caches = init_caches(cfg, b, cache_len, device=x.device)
    for i, st in enumerate(cfg.stages):
        x = _prefill_stage(params[f"dec{i}"], st, x, ctx, caches[f"dec{i}"],
                           cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x[:, -1:, :]), caches


def _prefill_stage(stage_params: dict, st, x: torch.Tensor, ctx: LayerCtx,
                   caches: dict, cache_len: int) -> torch.Tensor:
    for r in range(st.repeats):
        for i, ld in enumerate(st.pattern):
            x = _prefill_layer(take_layer(stage_params[f"p{i}"], r), ld, x,
                               ctx, take_layer(caches[f"p{i}"], r),
                               cache_len)
    return x


def _prefill_layer(p: dict, ld, x: torch.Tensor, ctx: LayerCtx, cache: dict,
                   cache_len: int) -> torch.Tensor:
    """Run the layer in full-sequence mode, then write its K/V into the
    cache (recomputed from the same normed input, as the JAX prefill does)."""
    x_out, _ = layer_apply(p, ld, x, ctx, cache=None)
    h = rmsnorm(p["norm1"], x, ctx.cfg.norm_eps)
    _fill_kv(p["mixer"], h, ctx.cfg, ctx, cache["self"], cache_len)
    return x_out


def _fill_kv(p: dict, h: torch.Tensor, cfg: ModelConfig, ctx: LayerCtx,
             cache: dict, cache_len: int) -> dict:
    k, v = project_kv(p, h, ctx.positions, cfg)
    return _scatter_tail(cache, {"k": k, "v": v}, ctx.positions, cache_len,
                         ctx.window)


def _scatter_tail(cache: dict, seqs: dict, positions: torch.Tensor,
                  cache_len: int, window: int) -> dict:
    """Write per-position values into the cache (in place) honouring
    rotation."""
    t = positions.shape[0]
    if window <= 0 or t <= cache_len:
        # contiguous write at slot 0 (prefill starts at position 0)
        n = min(t, cache_len)
        for name, val in seqs.items():
            cache[name][:, :n] = val[:, -n:].to(cache[name].dtype)
        cache["positions"].fill_(-1)
        cache["positions"][:, :n] = positions[-n:].to(torch.int32)
        return cache
    # rotating: keep only the last cache_len positions, placed at pos % len
    tail_pos = positions[-cache_len:]
    slots = (tail_pos % cache_len).long()
    for name, val in seqs.items():
        cache[name][:, slots] = val[:, -cache_len:].to(cache[name].dtype)
    pos_row = torch.zeros((cache_len,), dtype=torch.int32,
                          device=positions.device)
    pos_row[slots] = tail_pos.to(torch.int32)
    cache["positions"][:] = pos_row
    return cache


def decode_step(params: Params, cfg: ModelConfig, caches: Caches,
                token: torch.Tensor, pos: int) -> tuple[torch.Tensor, Caches]:
    """One-token decode against the caches (written in place).

    token [B, 1] int, pos the current absolute position as a host int.
    Returns (logits [B, 1, V], caches).
    """
    pos = int(pos)
    x = embed_tokens(params, cfg, token)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    ctx = LayerCtx(cfg=cfg, positions=positions, causal=True,
                   window=cfg.sliding_window, pos=pos)
    for i, st in enumerate(cfg.stages):
        x, _ = stage_apply(params[f"dec{i}"], st, x, ctx,
                           caches=caches[f"dec{i}"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), caches
