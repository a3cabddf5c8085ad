"""Dense SwiGLU FFN (port of the JAX package's ``models/layers/ffn.py``;
mixture-of-experts waits for its architectures, see ROADMAP.md)."""
from __future__ import annotations

import torch

from .common import dense_init, swiglu


def ffn_init(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {
        "wg": dense_init(generator, d_model, d_ff, dtype=dtype),
        "wu": dense_init(generator, d_model, d_ff, dtype=dtype),
        "wd": dense_init(generator, d_ff, d_model, dtype=dtype),
    }


def ffn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.matmul(x, params["wg"])
    up = torch.matmul(x, params["wu"])
    return torch.matmul(swiglu(gate, up), params["wd"])
