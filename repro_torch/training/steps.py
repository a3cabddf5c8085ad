"""Step factories: prefill_step and serve_step (port of the JAX package's
``training/steps.py``; the train step waits for its ROADMAP item).

Each factory resolves its device once; the returned step runs under
``torch.inference_mode()`` and greedy-decodes over the real vocabulary
(``[:vocab_size]`` of the padded one).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len: int, *,
                      device: str | torch.device = "cuda") -> Callable:
    """The prompt's prefill: ``batch`` as ``model.forward`` takes it (tokens,
    and a modality model's ``modality_emb``), moved to the device."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def prefill_step(params, batch):
        batch = {name: val.to(dev) for name, val in batch.items()}
        logits, caches = M.prefill(params, cfg, batch, cache_len)
        next_token = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_token.to(torch.int32), caches

    return prefill_step


def make_serve_step(cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> Callable:
    """ONE new token against the KV caches (the decode shapes)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def serve_step(params, caches, token, pos: int):
        logits, caches = M.decode_step(params, cfg, caches, token.to(dev),
                                       pos)
        next_token = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)
        return next_token.to(torch.int32)[:, None], caches

    return serve_step
