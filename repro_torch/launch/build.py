"""Combo building for the dry run: one (architecture x input shape x mesh)
step, run once on abstract shards, with its per-device cost.

Counterpart of the JAX package's ``launch/build.py::lower_combo``.  The
params, optimizer state, caches and inputs are ``meta`` tensors (shapes,
no storage) distributed over the mesh as DTensors by the sharding rules,
exactly as ``lower_combo`` shards them (head padding and config updates
included, and for decode the cache rules' sequence-shard fallback).  The
step is the port's own (``training/steps.py``), run once under
:class:`cost_analysis.Recorder`; the model's own constants (positions,
RoPE tables, masks) join the DTensors as replicated
(``implicit_replication``).  JAX's ``unroll`` has no counterpart: the port
loops over layers in Python, so every layer is counted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import torch

from ..checkpoint.store import ShapeDtype
from ..configs import get_config
from ..configs.shapes import SHAPES, InputShape
from ..data.pipeline import input_specs, text_len
from ..kernels import _shard
from ..models import model as M
from ..models.config import ModelConfig
from ..models.head_padding import pad_heads_config
from ..models.sharding import RuleSet, batch_spec, cache_batch_rules, \
    distribute, distribute_tree, mesh_sizes
from ..training.optimizer import AdamWConfig, init_opt_state, tree_leaves
from ..training.steps import make_prefill_step, make_serve_step, \
    make_train_step
from .cost_analysis import Recorder, Roofline, analytic_model_flops, \
    roofline, tensors


def adapt_config(cfg: ModelConfig, shape: InputShape,
                 dtype: str = "bfloat16") -> ModelConfig:
    """The shape policy: long_500k switches attention archs to their
    sliding-window variant (sub-quadratic requirement)."""
    cfg = replace(cfg, param_dtype=dtype, activation_dtype=dtype)
    if shape.name == "long_500k" and cfg.uses_attention:
        cfg = cfg.with_sliding_window(cfg.long_context_window)
    return cfg


def decode_cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, shape.seq_len)
    return shape.seq_len


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


@dataclass
class Combo:
    arch: str
    shape: InputShape
    cfg: ModelConfig
    chips: int
    kind: str
    argument_bytes: int = 0       # per device, exact: the local shards
    output_bytes: int = 0         # per device, exact
    peak_bytes: int = 0           # per device, live storages: an estimate
    roofline: Optional[Roofline] = None
    kernels: dict = field(default_factory=dict)   # name -> [calls, fl, by]


def _meta(sd: ShapeDtype) -> torch.Tensor:
    return torch.empty(sd.shape, dtype=sd.dtype, device="meta")


def _batch(specs: dict, mesh, cfg: ModelConfig, shape: InputShape,
           ruleset: RuleSet) -> dict:
    """The inputs as DTensors of meta shards: each input's first two dims
    sharded as [B, T] tokens are (``batch_spec``), the rest replicated."""
    bspec = batch_spec(mesh, shape.global_batch, text_len(cfg, shape),
                       ruleset)
    return {name: distribute(_meta(sd), (bspec + (None,) * len(sd.shape))
                             [:len(sd.shape)], mesh)
            for name, sd in specs.items()}


def step_args(cfg: ModelConfig, shape: InputShape, mesh, *,
              ruleset: Optional[RuleSet] = None,
              opt: Optional[AdamWConfig] = None) -> tuple:
    """The step's arguments as DTensors of meta shards: (params, opt state,
    batch) to train, (params, batch, caches) to prefill, (params, caches,
    token, pos) to decode (``pos`` a host int, the last position)."""
    ruleset = ruleset or RuleSet()
    params = distribute_tree(M.abstract_params(cfg), M.params_axes(cfg),
                             mesh, ruleset)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        opt = opt or AdamWConfig()
        for p in tree_leaves(params):
            p.requires_grad_(True)
        state = init_opt_state(opt, M.abstract_params(cfg))
        axes = M.params_axes(cfg)
        opt_state = {"m": distribute_tree(state["m"], axes, mesh, ruleset),
                     "v": distribute_tree(state["v"], axes, mesh, ruleset),
                     "step": distribute(state["step"], (), mesh)}
        return params, opt_state, _batch(specs, mesh, cfg, shape, ruleset)
    # caches: decode's, which prefill also fills
    cache_len = decode_cache_len(cfg, shape)
    enc_len = shape.seq_len if cfg.is_encoder_decoder else 0
    model_sz = mesh_sizes(mesh).get("model", 1)
    # head-parallel cache sharding impossible => seq-shard on `model`: MLA's
    # latent cache has no head axis at all; GQA caches need kv_heads %
    # model == 0
    prefer_seq = cfg.mla is not None or cfg.n_kv_heads % model_sz != 0
    c_rules = cache_batch_rules(mesh, shape.global_batch, ruleset,
                                prefer_seq_shard=prefer_seq)
    caches = distribute_tree(
        M.abstract_caches(cfg, shape.global_batch, cache_len, enc_len),
        M.caches_axes(cfg), mesh, c_rules)
    if shape.kind == "prefill":
        return params, _batch(specs, mesh, cfg, shape, ruleset), caches
    tok_spec = batch_spec(mesh, shape.global_batch, 1, ruleset)
    token = distribute(_meta(specs["token"]), tok_spec, mesh)
    return params, caches, token, shape.seq_len - 1


def build_combo(
    arch: str,
    shape: str | InputShape,
    mesh,
    *,
    dtype: str = "bfloat16",
    ruleset: Optional[RuleSet] = None,
    moe_group_size: int = 256,
    remat: bool = True,
    opt: Optional[AdamWConfig] = None,
    cfg_override: Optional[ModelConfig] = None,
    pad_heads: int = 0,
    cfg_updates: Optional[dict] = None,
) -> Combo:
    """Run one step of ``arch`` at ``shape`` (a name of ``SHAPES`` or an
    ``InputShape``) once on abstract shards over ``mesh`` and count its
    per-device cost."""
    from torch.distributed.tensor.experimental import implicit_replication

    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg_override or adapt_config(get_config(arch), shape, dtype)
    if pad_heads:
        cfg = pad_heads_config(cfg, pad_heads)
    if cfg_updates:
        cfg = replace(cfg, **cfg_updates)
    ruleset = ruleset or RuleSet()
    chips = math.prod(mesh.shape)
    # the serving steps run under inference mode, whose views of a DTensor
    # made outside it fail: their arguments are made inside it
    with torch.inference_mode(shape.kind != "train"):
        args = step_args(cfg, shape, mesh, ruleset=ruleset, opt=opt)
    if shape.kind == "train":
        step = make_train_step(cfg, opt, remat=remat,
                               moe_group_size=moe_group_size, device="meta")
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, cache_len=shape.seq_len,
                                 moe_group_size=moe_group_size,
                                 device="meta")
    else:
        step = make_serve_step(cfg, moe_group_size=moe_group_size,
                               device="meta")
    combo = Combo(arch, shape, cfg, chips, shape.kind,
                  argument_bytes=_local_bytes(args))
    rec = Recorder()
    rec.live_from(args)
    with rec, _shard.recording(rec.kernel), implicit_replication():
        out = step(*args)
    combo.output_bytes = _local_bytes(out)
    combo.peak_bytes = rec.peak_bytes
    combo.kernels = rec.kernels
    combo.roofline = roofline(rec, chips, cfg.param_dtype,
                              analytic_model_flops(cfg, shape))
    return combo
