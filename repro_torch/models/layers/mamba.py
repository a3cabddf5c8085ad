"""Mamba selective-SSM mixer (arXiv:2312.00752), as used by Jamba
(arXiv:2403.19887).

Port of the JAX package's ``models/layers/mamba.py``.  The JAX layer scans
a prompt with a chunked associative scan over [B, chunk, d_inner, d_state]
terms; the port runs the same recurrence, h_t = exp(dt_t A) h_t-1 +
(dt_t x_t) B_t, as a loop over time on the [B, d_inner, d_state] f32 state
that emits y_t = h_t . C_t each step, and never holds the states of all
steps.  The JAX scan's padded steps are identities (a = 1, b = 0), so the
two give the same function and the same final state.

With a cache the loop starts from its (conv window, ssm state) and writes
the new ones back in place: one token is the decode step, a prompt (from
the fresh cache's zero state) is the prefill that fills the cache.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...kernels import _shard
from ..config import ModelConfig
from .common import dense_init, normal_init, silu


def mamba_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    """The JAX tree; ``a_log`` (S4D-real A) is f32 whatever ``dtype`` is."""
    mc = cfg.mamba
    d, di, ds, dtr = cfg.d_model, cfg.mamba_d_inner, mc.d_state, \
        cfg.mamba_dt_rank
    dev = generator.device
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                   device=dev)).expand(di, ds).contiguous()
    return {
        "in_proj": dense_init(generator, d, 2 * di, dtype=dtype),
        "conv_w": normal_init(generator, (mc.d_conv, di), mc.d_conv ** -0.5,
                              dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(generator, di, dtr + 2 * ds, dtype=dtype),
        "dt_proj": dense_init(generator, dtr, di, dtype=dtype),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),
        "a_log": a_log,
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, di, d, dtype=dtype),
    }


def mamba_axes(cfg: ModelConfig) -> dict:
    return {
        "in_proj": ("embed", "d_inner2"),
        "conv_w": ("conv", "d_inner"),
        "conv_b": ("d_inner",),
        "x_proj": ("d_inner", "dt_state"),
        "dt_proj": ("dt_rank", "d_inner"),
        "dt_bias": ("d_inner",),
        "a_log": ("d_inner", "state"),
        "d_skip": ("d_inner",),
        "out_proj": ("d_inner", "embed"),
    }


def init_mamba_cache(batch: int, cfg: ModelConfig, dtype: torch.dtype,
                     device: torch.device) -> dict:
    """The last d_conv - 1 conv inputs [B, k-1, di] and the f32 state
    [B, di, ds], all zero."""
    mc, di = cfg.mamba, cfg.mamba_d_inner
    return {
        "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_cache_axes() -> dict:
    return {
        "conv": ("batch", "conv", "d_inner"),
        "ssm": ("batch", "d_inner", "state"),
    }


def _ssm_terms(params: dict, xc: torch.Tensor, cfg: ModelConfig):
    """xc [..., di] (post-conv, post-silu) -> the selective terms before
    discretisation: (dt [..., di], B [..., ds], C [..., ds]), all f32.  The
    step's abar = exp(dt A) and bx = (dt x) B are formed one step at a time
    in :func:`_selective_scan`."""
    dtr, ds = cfg.mamba_dt_rank, cfg.mamba.d_state
    # a row-parallel product (d_inner sharded): reduced before dt's bias
    proj = _shard.reduce_partial(torch.matmul(xc, params["x_proj"]))
    dt_in, b, c = proj.split([dtr, ds, ds], dim=-1)
    dt = F.softplus(torch.matmul(dt_in, params["dt_proj"])
                    + params["dt_bias"]).float()
    return dt, b.float(), c.float()


def _conv_causal(params: dict, x: torch.Tensor,
                 prior: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv over time. x [B,T,di]; prior [B,k-1,di] (the
    inputs before x) or None (zeros)."""
    w = params["conv_w"]
    k, t = w.shape[0], x.shape[1]
    if prior is None:
        prior = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prior, x], dim=1)                       # [B, T+k-1, di]
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return out + params["conv_b"]


def _selective_scan(dt, a, dtx, b_t, c_t, h):
    """The recurrence over time from the state h [B, di, ds]: dt, dtx
    [B, T, di], a [di, ds], B and C [B, T, ds] -> (y [B, T, di], final h),
    f32.  A DTensor's shards run it with batch and d_inner as they are
    sharded and the rest gathered; on meta tensors (the dry run) the T
    steps are not run: empty outputs, and the loop's work reported as
    ``kernels._shard`` reports a kernel's, as the dispatch-level count
    would find it (its products' FLOPs, each op's inputs and outputs)."""
    if _shard.is_dtensor(dt):
        return _shard.local_call(
            _selective_scan, (dt, a, dtx, b_t, c_t, h),
            ((0, 2), (None, 0), (0, 2), (0, None), (0, None), (0, 1)),
            ((0, 2), (0, 1)))
    bsz, t, di = dt.shape
    if dt.device.type == "meta":
        ds = a.shape[1]
        state, row, srow = 4 * bsz * di * ds, 4 * bsz * di, 4 * bsz * ds
        step = 11 * state + 3 * row + 2 * srow + 4 * di * ds
        cost = (2.0 * bsz * t * di * ds, t * step + 2 * 4 * bsz * t * di)
        # the backward as about twice the forward's work
        return _shard.meta_op("mamba_scan", (dt, a, dtx, b_t, c_t, h),
                              (((bsz, t, di), dt.dtype), (h.shape, h.dtype)),
                              cost, (2 * cost[0], 2 * cost[1]))
    ys = []
    for i in range(t):
        h = torch.exp(dt[:, i, :, None] * a) * h + \
            dtx[:, i, :, None] * b_t[:, i, None, :]
        ys.append(torch.matmul(h, c_t[:, i, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def mamba_apply(
    params: dict,
    x: torch.Tensor,                    # [B, T, d]
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """-> (output [B, T, d], cache written in place or None)."""
    di = cfg.mamba_d_inner
    xz = torch.matmul(x, params["in_proj"])
    xi, z = xz[..., :di], xz[..., di:]
    prior = cache["conv"] if cache is not None else None
    xc = silu(_conv_causal(params, xi, prior))
    dt, b_t, c_t = _ssm_terms(params, xc, cfg)
    a = -torch.exp(params["a_log"])                         # [di, ds]
    dtx = dt * xc.float()                                   # [B, T, di]
    h = cache["ssm"] if cache is not None else \
        dt.new_zeros((x.shape[0], di, a.shape[1]))
    y, h = _selective_scan(dt, a, dtx, b_t, c_t, h)        # y [B, T, di] f32
    if cache is not None:                   # the last k-1 inputs, the state
        cache["conv"].copy_(torch.cat([prior, xi], dim=1)[:, xi.shape[1]:])
        cache["ssm"].copy_(h)

    y = y.to(x.dtype) + params["d_skip"] * xi
    y = y * silu(z)
    return torch.matmul(y, params["out_proj"]), cache
