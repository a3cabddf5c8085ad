"""Synthetic data pipeline: deterministic numpy token/embedding batch
streams for training loops (port of the JAX package's
``data/pipeline.py``; the same arrays for the same seed), and
``input_specs``: the shapes and dtypes of every input of a step kind, for
the dry run (``launch/build.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..checkpoint.store import ShapeDtype
from ..configs.shapes import InputShape
from ..models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Zipf-ish unigram distribution so the CE has realistic structure.
    zipf_a: float = 1.2


def _token_probs(vocab: int, a: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, vocab + 1), a)
    return w / w.sum()


def _modality_len(cfg: ModelConfig, shape: InputShape) -> int:
    if not cfg.modality_embed_dim:
        return 0
    if cfg.is_encoder_decoder:
        return shape.seq_len                # audio frames == seq_len
    return min(cfg.n_modality_tokens, max(shape.seq_len // 2, 1))


def text_len(cfg: ModelConfig, shape: InputShape) -> int:
    """Text tokens for a full-sequence step (total seq budget minus any
    prepended modality tokens for decoder-only multimodal archs)."""
    if cfg.modality_embed_dim and not cfg.is_encoder_decoder:
        return shape.seq_len - _modality_len(cfg, shape)
    return shape.seq_len


def train_batches(
    cfg: ModelConfig,
    shape: InputShape,
    data: Optional[DataConfig] = None,
    batch_override: Optional[int] = None,
) -> Iterator[dict]:
    """Infinite iterator of numpy training batches."""
    data = data or DataConfig()
    rng = np.random.default_rng(data.seed)
    probs = _token_probs(cfg.vocab_size, data.zipf_a)
    b = batch_override or shape.global_batch
    t = text_len(cfg, shape)
    s_mod = _modality_len(cfg, shape)
    while True:
        tokens = rng.choice(cfg.vocab_size, size=(b, t),
                            p=probs).astype(np.int32)
        batch = {
            "tokens": tokens,
            "labels": np.concatenate(
                [tokens[:, 1:], np.full((b, 1), -1, np.int32)], axis=1),
        }
        if s_mod:
            batch["modality_emb"] = rng.standard_normal(
                (b, s_mod, cfg.modality_embed_dim), dtype=np.float32)
        yield batch


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """``ShapeDtype`` stand-ins (torch dtypes) for every input of the step
    kind, as the JAX ``input_specs`` gives ``ShapeDtypeStruct``s: tokens
    (and labels to train, a modality model's embeddings in the activation
    dtype) for a full-sequence step; ONE token and the position scalar to
    decode (the caches are built separately)."""
    b = shape.global_batch
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        t = text_len(cfg, shape)
        spec = {"tokens": ShapeDtype((b, t), i32)}
        if shape.kind == "train":
            spec["labels"] = ShapeDtype((b, t), i32)
        if cfg.modality_embed_dim:
            spec["modality_emb"] = ShapeDtype(
                (b, _modality_len(cfg, shape), cfg.modality_embed_dim),
                getattr(torch, cfg.activation_dtype))
        return spec
    return {"token": ShapeDtype((b, 1), i32), "pos": ShapeDtype((), i32)}
