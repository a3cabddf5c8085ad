"""The model: embeddings, an optional modality projector and encoder,
decoder stages, tied or untied LM head, with init / forward / prefill /
decode_step entry points.

Port of the JAX package's ``models/model.py`` for every architecture of its
registry: attention, MLA, Mamba, mLSTM and sLSTM mixers with dense, MoE or
no FFN, with or without cross-attention.  Modality models
take precomputed frame or patch embeddings (``batch["modality_emb"]``)
through a learned two-layer projector: a decoder-only model (llava)
prepends them to the token embeddings, an encoder-decoder (seamless)
encodes them and its decoder layers cross-attend to the encoder output.

Caches are written in place: ``prefill`` fills freshly allocated caches
(K/V slots, MLA latents, a cross layer's encoder K/V, or the recurrent
states of the Mamba and xLSTM layers) and ``decode_step`` updates each
layer's cache in the caches it is given and returns the same dict.
``forward`` returns the logits and the summed MoE aux loss, as the JAX one
does; ``mtp_depth`` (deepseek-v3's multi-token prediction head) is a config
field that the JAX model never reads, and the port ignores it too.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import _shard
from .blocks import LayerCtx, layer_apply, layer_params, stage_apply, \
    stage_axes, stage_cache_axes, stage_cache_init, stage_init, take_layer
from .config import ModelConfig
from .layers.attention import cross_kv, project_kv
from .layers.mla import _compress
from .layers.xlstm import fill_mlstm_cache
from .layers.common import dense_init, draws_into, normal_init, rmsnorm, \
    rmsnorm_axes, rmsnorm_init

Params = dict
Caches = dict


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# --------------------------------------------------------------------------- #
# Init                                                                        #
# --------------------------------------------------------------------------- #


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: str | torch.device = "cuda") -> Params:
    """Random params with the JAX package's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; on ``"meta"``
    the tree's shapes and dtypes with nothing drawn (a generator cannot
    live there): :func:`abstract_params`."""
    dev = resolve_device(device)
    if dev.type == "meta":
        with draws_into(dry=True):
            return _init_params(cfg, SimpleNamespace(device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init_params(cfg, gen)


def _init_params(cfg: ModelConfig, gen) -> Params:
    dev = gen.device
    dt = _dtype(cfg)
    p: Params = {
        "embed": normal_init(gen, (cfg.padded_vocab, cfg.d_model), 0.02, dt),
        "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                  dtype=dt)
    if cfg.modality_embed_dim:
        p["proj_in"] = dense_init(gen, cfg.modality_embed_dim, cfg.d_model,
                                  dtype=dt)
        p["proj_mid"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype=dt)
    for i, st in enumerate(cfg.encoder_stages):
        p[f"enc{i}"] = stage_init(gen, st, cfg, dt)
    if cfg.encoder_stages:
        p["enc_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
    for i, st in enumerate(cfg.stages):
        p[f"dec{i}"] = stage_init(gen, st, cfg, dt)
    return p


def params_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_params`'s tree, leaf for leaf."""
    a: dict = {
        "embed": ("vocab", "embed"),
        "final_norm": rmsnorm_axes(),
    }
    if not cfg.tie_embeddings:
        a["lm_head"] = ("embed", "vocab")
    if cfg.modality_embed_dim:
        a["proj_in"] = ("modality", "embed")
        a["proj_mid"] = ("embed", "embed2")
    for i, st in enumerate(cfg.encoder_stages):
        a[f"enc{i}"] = stage_axes(st, cfg)
    if cfg.encoder_stages:
        a["enc_norm"] = rmsnorm_axes()
    for i, st in enumerate(cfg.stages):
        a[f"dec{i}"] = stage_axes(st, cfg)
    return a


def abstract_params(cfg: ModelConfig) -> Params:
    """The param tree as ``meta`` tensors (shapes and dtypes, no storage,
    nothing drawn) for the dry run."""
    return init_params(cfg, device="meta")


# --------------------------------------------------------------------------- #
# Embedding / head                                                            #
# --------------------------------------------------------------------------- #


def embed_tokens(params: Params, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings; a DTensor table is gathered over the
    data-parallel axes and looked up shard by shard over its vocab
    (``_shard.vocab_lookup``)."""
    if _shard.is_dtensor(params["embed"]):
        return _shard.settle(_shard.vocab_lookup(
            _shard.unshard(params["embed"]), tokens))
    return params["embed"][tokens]


def project_modality(params: Params, emb: torch.Tensor) -> torch.Tensor:
    """emb [B, S, modality_dim] -> [B, S, d]: two projections with the
    tanh-approximated GELU between them (``jax.nn.gelu``'s default)."""
    w_in = _shard.unshard(params["proj_in"])
    h = torch.matmul(emb.to(w_in.dtype), w_in)
    return torch.matmul(F.gelu(h, approximate="tanh"),
                        _shard.unshard(params["proj_mid"]))


def lm_logits(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.matmul(x, _shard.unshard(params["embed"]).t())
    return torch.matmul(x, _shard.unshard(params["lm_head"]))


def _positions(t: int, device: torch.device) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=device)


# --------------------------------------------------------------------------- #
# Encoder                                                                     #
# --------------------------------------------------------------------------- #


def encode(params: Params, cfg: ModelConfig, enc_input: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """enc_input [B, S, d] (projected frame embeddings) -> the normed
    encoder output: unmasked self-attention with RoPE at 0..S-1."""
    ctx = LayerCtx(cfg=cfg, positions=_positions(enc_input.shape[1],
                                                 enc_input.device),
                   causal=False)
    x = enc_input
    for i, st in enumerate(cfg.encoder_stages):
        x, _, _ = stage_apply(params[f"enc{i}"], st, x, ctx, remat=remat)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _encoder_output(params: Params, cfg: ModelConfig, batch: dict, *,
                    remat: bool = False):
    if not cfg.is_encoder_decoder:
        return None
    return encode(params, cfg, project_modality(params,
                                                batch["modality_emb"]),
                  remat=remat)


def prefix_len(cfg: ModelConfig) -> int:
    """Decoder positions before the first text token: a decoder-only
    modality model's ``n_modality_tokens`` projected patches, else 0.  A
    decode position counts them."""
    if cfg.modality_embed_dim and not cfg.is_encoder_decoder:
        return cfg.n_modality_tokens
    return 0


def _decoder_input(params: Params, cfg: ModelConfig,
                   batch: dict) -> torch.Tensor:
    """[B, T, d] decoder input: the token embeddings, after the projected
    modality embeddings where a decoder-only model takes them."""
    x = embed_tokens(params, cfg, batch["tokens"])
    if prefix_len(cfg):
        vis = project_modality(params, batch["modality_emb"])
        x = torch.cat([vis.to(x.dtype), x], dim=1)
    return x


# --------------------------------------------------------------------------- #
# Decoder forward (full sequence)                                             #
# --------------------------------------------------------------------------- #


def forward(params: Params, cfg: ModelConfig, batch: dict, *,
            remat: bool = False,
            moe_group_size: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens": [B, T_text] int, "modality_emb": [B, S_mod,
    modality_dim] (modality models)} -> (logits [B, T, padded_vocab], T
    counting a decoder-only model's modality positions; the MoE layers'
    summed aux loss, an f32 scalar, 0 without MoE).  ``remat`` recomputes
    each layer repeat in the backward (the train step's default);
    ``moe_group_size`` is the MoE layers' dispatch group."""
    enc_out = _encoder_output(params, cfg, batch, remat=remat)
    x = _decoder_input(params, cfg, batch)
    ctx = LayerCtx(cfg=cfg, positions=_positions(x.shape[1], x.device),
                   causal=True, window=cfg.sliding_window, enc_out=enc_out,
                   moe_group_size=moe_group_size)
    aux = 0.0
    for i, st in enumerate(cfg.stages):
        x, _, a = stage_apply(params[f"dec{i}"], st, x, ctx, remat=remat)
        aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), torch.as_tensor(
        aux, dtype=torch.float32, device=x.device)


# --------------------------------------------------------------------------- #
# KV caches                                                                   #
# --------------------------------------------------------------------------- #


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                enc_len: int = 0, *, device: str | torch.device) -> Caches:
    dev = torch.device(device)
    return {
        f"dec{i}": stage_cache_init(st, cfg, batch, cache_len, _dtype(cfg),
                                    dev, enc_len)
        for i, st in enumerate(cfg.stages)
    }


def caches_axes(cfg: ModelConfig) -> dict:
    return {f"dec{i}": stage_cache_axes(st)
            for i, st in enumerate(cfg.stages)}


def abstract_caches(cfg: ModelConfig, batch: int, cache_len: int,
                    enc_len: int = 0) -> Caches:
    """:func:`init_caches`'s tree as ``meta`` tensors."""
    return init_caches(cfg, batch, cache_len, enc_len, device="meta")


# --------------------------------------------------------------------------- #
# Prefill (fill caches with a prompt) and single-token decode                 #
# --------------------------------------------------------------------------- #


def prefill(params: Params, cfg: ModelConfig, batch: dict,
            cache_len: int, *, moe_group_size: int = 256,
            caches: Caches | None = None) -> tuple[torch.Tensor, Caches]:
    """Runs the full prompt (``batch`` as :func:`forward` takes it),
    returns (last-position logits [B, 1, V], filled caches): ``caches``
    where given (as :func:`init_caches` makes them, e.g. sharded), else
    fresh ones."""
    enc_out = _encoder_output(params, cfg, batch)
    x = _decoder_input(params, cfg, batch)
    b, t, _ = x.shape
    ctx = LayerCtx(cfg=cfg, positions=_positions(t, x.device), causal=True,
                   window=cfg.sliding_window, enc_out=enc_out,
                   moe_group_size=moe_group_size)
    enc_len = enc_out.shape[1] if enc_out is not None else 0
    if caches is None:
        caches = init_caches(cfg, b, cache_len, enc_len, device=x.device)
    for i, st in enumerate(cfg.stages):
        x = _prefill_stage(params[f"dec{i}"], st, x, ctx, caches[f"dec{i}"],
                           cache_len)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x[:, -1:, :]), caches


def _prefill_stage(stage_params: dict, st, x: torch.Tensor, ctx: LayerCtx,
                   caches: dict, cache_len: int) -> torch.Tensor:
    for r in range(st.repeats):
        for i, ld in enumerate(st.pattern):
            x = _shard.settle(_prefill_layer(
                layer_params(stage_params[f"p{i}"], r), ld, x, ctx,
                take_layer(caches[f"p{i}"], r), cache_len))
    return x


def _prefill_layer(p: dict, ld, x: torch.Tensor, ctx: LayerCtx, cache: dict,
                   cache_len: int) -> torch.Tensor:
    """Run the layer over the prompt and fill its cache.

    Attention, MLA and mLSTM run in full-sequence mode, then recompute their
    cacheable values (K/V, the MLA latents, the mLSTM state and conv tail)
    from the same normed input, as the JAX prefill does.  Mamba and sLSTM
    run their one recurrence from the fresh cache, which holds the zero
    state: the same call gives the outputs and writes the final state (and
    Mamba's conv tail) into the cache, where the JAX prefill runs the
    recurrence a second time.  A cross layer writes the encoder K/V into its
    cache first and the layer reads them there, where the JAX prefill
    computes them twice."""
    if ld.mixer in ("slstm", "mamba"):
        x_out, _, _ = layer_apply(p, ld, x, ctx, cache=cache)
        return x_out
    cross = None
    if ld.cross_attn:
        for name, val in cross_kv(p["cross"], ctx.enc_out).items():
            cache["cross"][name].copy_(val)
        cross = {"cross": cache["cross"]}
    x_out, _, _ = layer_apply(p, ld, x, ctx, cache=cross)
    h = rmsnorm(p["norm1"], x, ctx.cfg.norm_eps)
    if ld.mixer == "mlstm":
        fill_mlstm_cache(p["mixer"], h, cache["self"])
    elif ld.mixer == "mla":
        c_kv, k_rope = _compress(p["mixer"], h, ctx.cfg, ctx.positions)
        _scatter_tail(cache["self"], {"c_kv": c_kv, "k_rope": k_rope},
                      ctx.positions, cache_len, ctx.window)
    else:
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
                token: torch.Tensor, pos: int | torch.Tensor, *,
                moe_group_size: int = 256) -> tuple[torch.Tensor, Caches]:
    """One-token decode against the caches (written in place).

    token [B, 1] int, pos the current absolute position (a decoder-only
    modality model's prefix counts): a host int, or a 0-d int32 tensor on
    the caches' device, which the step reads there (the positions, the
    cache slot and the decode kernel's mask), so that one CUDA graph of
    the step serves every position.  A cross layer reads the encoder K/V
    that prefill left in its cache.  Returns (logits [B, 1, V], caches).
    """
    x = embed_tokens(params, cfg, token)
    if isinstance(pos, torch.Tensor):
        pos = pos.to(device=x.device, dtype=torch.int32)
        positions = pos.reshape(1)
    else:
        pos = int(pos)
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=x.device)
    ctx = LayerCtx(cfg=cfg, positions=positions, causal=True,
                   window=cfg.sliding_window, pos=pos,
                   moe_group_size=moe_group_size)
    for i, st in enumerate(cfg.stages):
        x, _, _ = stage_apply(params[f"dec{i}"], st, x, ctx,
                              caches=caches[f"dec{i}"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return lm_logits(params, cfg, x), caches
