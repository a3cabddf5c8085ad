"""Shared primitives: norms, RoPE, activations, initialisers.

Port of the JAX package's ``models/layers/common.py``.  Initialisers draw
from an explicit ``torch.Generator`` on the device it lives on; they give
the same distributions as the JAX ones, not the same numbers.
"""
from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from ...kernels import _shard

# --------------------------------------------------------------------------- #
# Initialisers                                                                #
# --------------------------------------------------------------------------- #

# While ``draws_into`` is active: the tensors that ``normal_init`` draws
# into, in the order it is called; the list it appends each tensor it
# returns to; and whether it draws nothing and returns meta tensors (a dry
# run that gives shapes).  Lets a stage's stacked params be drawn straight
# into their slots.
_draw_slots: ContextVar[Optional[Iterator[torch.Tensor]]] = \
    ContextVar("draw_slots", default=None)
_draw_log: ContextVar[Optional[list]] = ContextVar("draw_log", default=None)
_draw_dry: ContextVar[bool] = ContextVar("draw_dry", default=False)


@contextmanager
def draws_into(slots: Optional[list] = None, record: Optional[list] = None,
               dry: bool = False):
    """Within the block, ``normal_init`` draws into the next tensor of
    ``slots`` (the shape and dtype it would make, in call order) instead of
    allocating one, or with ``dry`` draws nothing and returns a meta tensor
    (the generator does not advance); it appends every tensor it returns to
    ``record``."""
    tokens = (_draw_slots.set(None if slots is None else iter(slots)),
              _draw_log.set(record), _draw_dry.set(dry))
    try:
        yield
    finally:
        _draw_slots.reset(tokens[0])
        _draw_log.reset(tokens[1])
        _draw_dry.reset(tokens[2])


def normal_init(generator: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``scale`` x a standard normal draw in f32, cast to ``dtype``.  Scaled
    in place: an expert tensor of deepseek-v3 is 15 GB in f32."""
    shape = tuple(shape)
    slots = _draw_slots.get()
    slot = None if slots is None else next(slots)
    if slot is not None and (tuple(slot.shape) != shape or
                             slot.dtype != dtype):
        raise ValueError(f"draw of {shape} {dtype} into a slot of "
                         f"{tuple(slot.shape)} {slot.dtype}")
    if _draw_dry.get():
        x = torch.empty(shape, dtype=dtype, device="meta")
    elif slot is not None and dtype == torch.float32:
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32, out=slot).mul_(scale)
    else:
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32).mul_(scale).to(dtype)
        if slot is not None:
            x = slot.copy_(x)
    log = _draw_log.get()
    if log is not None:
        log.append(x)
    return x


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


def rmsnorm_axes(axis: str = "embed") -> dict:
    return {"scale": (axis,)}


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


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``; a DTensor is first gathered on the dims the
    reshape changes (``_shard.reshape``: its heads may not split evenly)."""
    if _shard.is_dtensor(x):
        return _shard.reshape(x, shape)
    return x.reshape(shape)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; a DTensor's shards run it as they lie (DTensor has
    no sharding rule for its backward)."""
    if _shard.is_dtensor(x):
        return _shard.along(F.logsigmoid, x)
    return F.logsigmoid(x)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``; a DTensor's shards run it with ``dim`` gathered
    (DTensor has no rule for the flip in its backward)."""
    if _shard.is_dtensor(x):
        return _shard.along(lambda t: torch.cumsum(t, dim=dim), x, dim)
    return torch.cumsum(x, dim=dim)


def pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with ``n`` zeros appended to its last axis; a DTensor's shards pad
    their own (the last axis gathered)."""
    if _shard.is_dtensor(x):
        return _shard.along(lambda t: F.pad(t, (0, n)), x, -1)
    return F.pad(x, (0, n))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


# --------------------------------------------------------------------------- #
# Stable helpers                                                              #
# --------------------------------------------------------------------------- #


def softmax_f32(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax in f32 whatever the input dtype.  The JAX twin has no caller
    in the JAX package (its MoE router calls ``jax.nn.softmax`` on f32
    logits); kept for parity of the module."""
    return torch.softmax(scores.float(), dim=dim)


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
