"""Shared primitives: norms, RoPE, activations, initialisers.

Port of the JAX package's ``models/layers/common.py``.  Initialisers draw
from an explicit ``torch.Generator`` on the device it lives on; they give
the same distributions as the JAX ones, not the same numbers.
"""
from __future__ import annotations

import torch

# --------------------------------------------------------------------------- #
# Initialisers                                                                #
# --------------------------------------------------------------------------- #


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (scale * x).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, *out_dims: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Fan-in scaled normal for a [in, *out] projection."""
    return normal_init(generator, (in_dim, *out_dims), in_dim ** -0.5, dtype)


# --------------------------------------------------------------------------- #
# Norms                                                                       #
# --------------------------------------------------------------------------- #


def rmsnorm_init(dim: int, dtype: torch.dtype,
                 device: torch.device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dtype)


def groupnorm_heads(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the last (head_dim) axis, no learned params;
    f32 math with the population variance, output in the input dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps)).to(dtype)


# --------------------------------------------------------------------------- #
# RoPE                                                                        #
# --------------------------------------------------------------------------- #


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | None = None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [...,] -> cos/sin tables [..., head_dim // 2]."""
    angles = positions.float()[..., None] * rope_freqs(
        head_dim, theta, positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., T, H, D]; cos/sin [T, D/2]; half-split rotation in f32."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dtype)


# --------------------------------------------------------------------------- #
# Activations                                                                 #
# --------------------------------------------------------------------------- #


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


# --------------------------------------------------------------------------- #
# Stable helpers                                                              #
# --------------------------------------------------------------------------- #


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax in f32 over ``dim`` with masked entries excluded; a row with
    no valid entry yields 0 (not the uniform average of a -inf row)."""
    neg = torch.finfo(torch.float32).min
    scores = scores.float().masked_fill(~mask, neg)
    out = torch.softmax(scores, dim=dim)
    any_valid = mask.any(dim=dim, keepdim=True)
    return torch.where(any_valid, out, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))
