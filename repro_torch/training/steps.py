"""Step factories: train_step / prefill_step / serve_step (port of the JAX
package's ``training/steps.py``).

Each factory resolves its device once.  The train step differentiates
``loss_fn`` with ``torch.autograd.grad`` (attention through the flash
kernel's backward on the card) and applies AdamW in place.  The prefill
and serve steps run under ``torch.inference_mode()`` and greedy-decode
over the real vocabulary (``[:vocab_size]`` of the padded one).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..device import resolve_device
from ..kernels import _shard
from ..models import model as M
from ..models.config import ModelConfig
from ..tracing import span
from . import graphs
from .optimizer import AdamWConfig, adamw_update, init_opt_state, \
    tree_leaves


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean next-token CE; positions with label < 0 are masked.  Padded
    vocab tail can never be a label (labels < vocab_size), so no extra
    masking of logits is needed for the loss.  Log-sum-exp in f32."""
    logits = logits.float()
    ids = labels.clamp(min=0).long()
    if _shard.is_dtensor(logits):
        # vocab-parallel: a max and a sum over the vocab shards, and each
        # shard picks the labels in its range (DTensor's logsumexp and
        # gather would gather the logits)
        top = logits.amax(dim=-1, keepdim=True).detach()
        logz = (logits - top).exp().sum(dim=-1).log() + top[..., 0]
        gold = _shard.vocab_gather(logits, ids)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ids[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True,
            moe_group_size: int = 256) -> tuple[torch.Tensor, dict]:
    """CE over the text positions (a decoder-only modality model prepends
    its modality positions, which carry no label) plus the MoE aux loss ->
    (loss, {"ce", "aux"})."""
    logits, aux = M.forward(params, cfg, batch, remat=remat,
                            moe_group_size=moe_group_size)
    t_text = batch["labels"].shape[1]
    if t_text < logits.shape[1]:         # the modality positions have none
        logits = logits[:, -t_text:, :]
    ce = cross_entropy(logits, batch["labels"],
                       cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}


def loss_and_grads(params: dict, cfg: ModelConfig, batch: dict, *,
                   remat: bool = True, moe_group_size: int = 256
                   ) -> tuple[torch.Tensor, dict, dict]:
    """(loss, {"ce", "aux"}, grads): :func:`loss_fn` on ``batch`` (numpy
    arrays or tensors, moved to the params' device, ids as int64) and its
    gradient with respect to every param leaf, as a tree like ``params``.
    The leaves are made to require grad; the returned values are
    detached."""
    leaves = list(tree_leaves(params))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    batch = {k: (v if v.is_floating_point() else v.long()).to(
        leaves[0].device) for k, v in batch.items()}
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, parts = loss_fn(params, cfg, batch, remat=remat,
                              moe_group_size=moe_group_size)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        _tree_like(params, iter(grads))


def _tree_like(tree: dict, leaves) -> dict:
    """A tree of ``tree``'s structure holding ``leaves`` in its flatten
    order (sorted keys)."""
    return {k: _tree_like(tree[k], leaves) if isinstance(tree[k], dict)
            else next(leaves) for k in sorted(tree)}


def make_train_step(cfg: ModelConfig, opt: Optional[AdamWConfig] = None, *,
                    remat: bool = True, moe_group_size: int = 256,
                    device: str | torch.device = "cuda") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce", "aux", "grad_norm", "lr"})``: :func:`loss_and_grads`,
    then one AdamW step in place (the same dicts come back; metrics are
    device scalars).  ``batch`` holds numpy arrays or tensors
    (``train_batches`` gives numpy); params and optimizer state live on
    ``device``.  Under a profiler the two phases are spans,
    ``train.grads`` and ``train.optimizer``; the optimizer's is also timed on
    the card by CUDA events there."""
    opt = opt or AdamWConfig()
    timed = resolve_device(device).type == "cuda"

    def train_step(params, opt_state, batch):
        with span("train.grads"):
            loss, parts, grads = loss_and_grads(
                params, cfg, batch, remat=remat,
                moe_group_size=moe_group_size)
        with span("train.optimizer", device=timed):
            params, opt_state, om = adamw_update(opt, params, grads,
                                                 opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     opt: Optional[AdamWConfig] = None, *,
                     device: str | torch.device = "cuda"
                     ) -> tuple[dict, dict]:
    """Random params from ``seed`` (leaves that require grad) and a zero
    optimizer state."""
    opt = opt or AdamWConfig()
    params = M.init_params(cfg, seed, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, init_opt_state(opt, params)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of [B, V] logits; a DTensor's shards run it
    with the vocab gathered and the batch left as it is sharded."""
    if _shard.is_dtensor(logits):
        return _shard.local_call(_greedy, (logits,), ((0, None),),
                                 ((0, None),))
    return torch.argmax(logits, dim=-1)


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``, left as it is where it lies there already (a
    DTensor's move is an op it refuses under inference mode)."""
    return t if t.device == dev else t.to(dev)


def make_prefill_step(cfg: ModelConfig, cache_len: int, *,
                      moe_group_size: int = 256,
                      device: str | torch.device = "cuda") -> Callable:
    """The prompt's prefill: ``batch`` as ``model.forward`` takes it (tokens,
    and a modality model's ``modality_emb``), moved to the device; the
    caches it fills are fresh ones unless ``caches`` are given (the dry
    run gives them sharded).  Where the CUDA graphs engage (``graphs.py``:
    a config they take, plain CUDA tensors, no ``caches`` given), each
    prompt shape's prefill is captured once and replayed, filling a cache
    tree that stays resident for these weights."""
    dev = resolve_device(device)
    graphed = graphs.supported(cfg)

    def run(params, batch, caches):
        logits, caches = M.prefill(params, cfg, batch, cache_len,
                                   moe_group_size=moe_group_size,
                                   caches=caches)
        next_token = _greedy(logits[:, -1, : cfg.vocab_size])
        return next_token.to(torch.int32), caches

    @torch.inference_mode()
    def prefill_step(params, batch, caches=None):
        batch = {name: _to(val, dev) for name, val in batch.items()}
        if graphed and caches is None and list(batch) == ["tokens"]:
            out = graphs.prefill(
                params, cfg, batch["tokens"], cache_len,
                lambda tokens, tree: run(params, {"tokens": tokens},
                                         tree)[0])
            if out is not None:
                return out
        return run(params, batch, caches)

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, moe_group_size: int = 256,
                    device: str | torch.device = "cuda") -> Callable:
    """ONE new token against the KV caches (the decode shapes).  Where the
    CUDA graphs engage (``graphs.py``: the caches the graphed prefill of
    these weights last handed out, a host-int position), one captured step
    is replayed at every position."""
    dev = resolve_device(device)
    graphed = graphs.supported(cfg)

    def run(params, caches, token, pos):
        logits, _ = M.decode_step(params, cfg, caches, token, pos,
                                  moe_group_size=moe_group_size)
        next_token = _greedy(logits[:, -1, : cfg.vocab_size])
        return next_token.to(torch.int32)[:, None]

    @torch.inference_mode()
    def serve_step(params, caches, token, pos):
        token = _to(token, dev)
        nxt = None
        if graphed:
            nxt = graphs.decode(
                params, cfg, caches, token, pos,
                lambda tok, at, tree: run(params, tree, tok, at))
        if nxt is None:
            nxt = run(params, caches, token, pos)
        return nxt, caches

    return serve_step
