"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelisable)
and sLSTM (scalar memory, sequential scan), both with exponential gating and
the max-state stabiliser.

Port of the JAX package's ``models/layers/xlstm.py``.  The mLSTM runs its
parallel (T x T decay-masked) form over a sequence, or its chunkwise form
where ``cfg.mlstm_chunk`` is set and the sequence is longer, and its
recurrent form against a cache.  Every sLSTM recurrence, a prompt's T
steps, a decode token's one or a training sequence's, goes through the
``slstm_scan`` op (the CUDA kernel on a card, its plain version on the
CPU); in training its gradient is the op's own backward (``SLSTMScanFn``:
the backward kernel on a card).  Unlike the JAX layers, a cache is
updated in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...kernels import _shard
from ...kernels.slstm_scan import slstm_scan
from ..config import ModelConfig
from .common import cumsum, dense_init, groupnorm_heads, log_sigmoid, \
    normal_init, reshape, silu

# =========================================================================== #
# mLSTM                                                                       #
# =========================================================================== #


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    return di, cfg.n_heads, di // cfg.n_heads


def mlstm_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    """The JAX tree: q/k/v dense ``[di, H, dh]``; the gate projections and
    biases stay f32 whatever ``dtype`` is."""
    d = cfg.d_model
    di, h, dh = _mlstm_dims(cfg)
    dev = generator.device
    return {
        "up_proj": dense_init(generator, d, 2 * di, dtype=dtype),
        "conv_w": dense_init(generator, cfg.xlstm.conv_kernel, di,
                             dtype=dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": dense_init(generator, di, h, dh, dtype=dtype),
        "wk": dense_init(generator, di, h, dh, dtype=dtype),
        "wv": dense_init(generator, di, h, dh, dtype=dtype),
        "w_i": dense_init(generator, di, h, dtype=torch.float32),
        "w_f": dense_init(generator, di, h, dtype=torch.float32),
        "b_i": torch.zeros((h,), dtype=torch.float32, device=dev),
        "b_f": torch.full((h,), 3.0, dtype=torch.float32, device=dev),
        "skip": torch.ones((di,), dtype=dtype, device=dev),
        "down_proj": dense_init(generator, di, d, dtype=dtype),
    }


def mlstm_axes(cfg: ModelConfig) -> dict:
    return {
        "up_proj": ("embed", "d_inner2"),
        "conv_w": ("conv", "d_inner"),
        "conv_b": ("d_inner",),
        "wq": ("d_inner", "heads", "head_dim"),
        "wk": ("d_inner", "heads", "head_dim"),
        "wv": ("d_inner", "heads", "head_dim"),
        "w_i": ("d_inner", "heads"),
        "w_f": ("d_inner", "heads"),
        "b_i": ("heads",),
        "b_f": ("heads",),
        "skip": ("d_inner",),
        "down_proj": ("d_inner", "embed"),
    }


def init_mlstm_cache(batch: int, cfg: ModelConfig, dtype: torch.dtype,
                     device: torch.device) -> dict:
    di, h, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, di),
                            dtype=dtype, device=device),
        "c": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=f32, device=device),
    }


def mlstm_cache_axes() -> dict:
    return {
        "conv": ("batch", "conv", "d_inner"),
        "c": ("batch", "heads", "head_dim", "head_dim2"),
        "n": ("batch", "heads", "head_dim"),
        "m": ("batch", "heads"),
    }


def _conv_causal(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 prior: Optional[torch.Tensor]) -> torch.Tensor:
    """Depthwise causal conv: w [K, di], x [B, T, di], prior [B, K-1, di]."""
    k = w.shape[0]
    if prior is None:
        prior = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prior, x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + t] * w[i]
    return out + b


def _proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, T, di] @ w [di, H, dh] -> [B, T, H, dh]."""
    bsz, t, di = x.shape
    return reshape(torch.matmul(x, reshape(w, di, -1)), bsz, t, *w.shape[1:])


def _qkv_gates(params: dict, xi: torch.Tensor):
    q = _proj_heads(xi, params["wq"])
    k = _proj_heads(xi, params["wk"])
    v = _proj_heads(xi, params["wv"])
    xf = xi.float()
    i_pre = torch.matmul(xf, params["w_i"]) + params["b_i"]
    f_pre = torch.matmul(xf, params["w_f"]) + params["b_f"]
    return q, k, v, i_pre, f_pre


def _mlstm_parallel(q, k, v, i_pre, f_pre) -> torch.Tensor:
    """The T x T decay-masked form over a whole sequence -> [B, T, H, dh]
    f32."""
    t, dh = q.shape[1], q.shape[3]
    logf = log_sigmoid(f_pre)                               # [B,T,H]
    cum = cumsum(logf, 1)
    # a[t, s] = sum_{j=s+1..t} logf_j + logi_s  (t >= s)
    amat = cum[:, :, None, :] - cum[:, None, :, :] + i_pre[:, None, :, :]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    amat = amat.masked_fill(~causal, float("-inf"))         # [B,Tq,Ts,H]
    m = amat.amax(dim=2, keepdim=True)                      # [B,T,1,H]
    dmat = torch.exp(amat - m)
    scale = dh ** -0.5
    scores = torch.einsum("bthk,bshk->btsh", q.float(), k.float()) * scale
    sd = scores * dmat
    norm = torch.maximum(sd.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))
    hout = torch.einsum("btsh,bshk->bthk", sd, v.float())
    return hout / (norm[..., None] + 1e-6)


def _mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int):
    """The chunkwise form: chunk x chunk decay-masked blocks and a (C, n, m)
    carry between chunks, with the stabiliser ``m_t = max_{s<=t} a_{t,s}``
    tracked exactly through the chunks.  A ragged last chunk runs short
    (the JAX form pads it, and its padded steps decay the carry), so the
    returned state is the state after step T-1.

    q/k/v [B,T,H,dh]; i_pre/f_pre [B,T,H] f32.  The carry starts at the
    zero state.  Returns (h_out [B,T,H,dh] f32, m_t [B,T,H], final state
    (C [B,H,dh,dh], n [B,H,dh], m [B,H]))."""
    b, t, h, dh = q.shape
    f32, dev = torch.float32, q.device
    c_st = torch.zeros((b, h, dh, dh), dtype=f32, device=dev)
    n_st = torch.zeros((b, h, dh), dtype=f32, device=dev)
    m_prev = torch.full((b, h), -1e30, dtype=f32, device=dev)
    scale = dh ** -0.5
    hs, ms = [], []
    for s0 in range(0, t, chunk):
        part = slice(s0, min(s0 + chunk, t))
        qc = q[:, part].float() * scale
        kc, vc = k[:, part].float(), v[:, part].float()
        cum = cumsum(log_sigmoid(f_pre[:, part]), 1)            # inclusive
        u = i_pre[:, part] - cum                            # i_s - cum_s
        w = torch.maximum(m_prev[:, None], torch.cummax(u, dim=1).values)
        m_t = cum + w                                   # row-max stabiliser
        # intra-chunk: D[t, s] = exp(u_s - w_t) for s <= t
        n = qc.shape[1]
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                       device=q.device))[None, :, :, None]
        dmat = torch.exp(u[:, None, :, :] - w[:, :, None, :]).masked_fill(
            ~causal, 0.0)
        scores = torch.einsum("blhk,bshk->blsh", qc, kc) * dmat
        num = torch.einsum("blsh,bshk->blhk", scores, vc)
        den = scores.sum(dim=2)                             # [B,L,H]
        # inter-chunk, from the carried state
        qg = qc * torch.exp(m_prev[:, None] - w)[..., None]
        num = num + torch.einsum("blhk,bhkj->blhj", qg, c_st)
        den = den + torch.einsum("blhk,bhk->blh", qg, n_st)
        hs.append(num / (torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
                         + 1e-6))
        ms.append(m_t)
        # the state at the chunk's last step
        w_last = w[:, -1]
        coeff = torch.exp(u - w_last[:, None])              # [B,L,H]
        decay = torch.exp(m_prev - w_last)
        c_st = decay[..., None, None] * c_st + torch.einsum(
            "bsh,bshk,bshj->bhkj", coeff, kc, vc)
        n_st = decay[..., None] * n_st + torch.einsum("bsh,bshk->bhk", coeff,
                                                      kc)
        m_prev = cum[:, -1] + w_last
    return torch.cat(hs, 1), torch.cat(ms, 1), (c_st, n_st, m_prev)


def _mlstm_update(cache: dict, k: torch.Tensor, v: torch.Tensor,
                  i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """One recurrent step written into ``cache`` (c, n, m) in place:
    k/v [B, H, dh] f32, gates [B, H].  Returns the new stabiliser m."""
    logf = log_sigmoid(f_pre)
    m_new = torch.maximum(logf + cache["m"], i_pre)
    f_eff = torch.exp(logf + cache["m"] - m_new)
    i_eff = torch.exp(i_pre - m_new)
    cache["c"].mul_(f_eff[..., None, None]).add_(
        (i_eff[..., None] * k)[..., :, None] * v[..., None, :])
    cache["n"].mul_(f_eff[..., None]).add_(i_eff[..., None] * k)
    cache["m"].copy_(m_new)
    return m_new


def mlstm_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Full sequence (``cache`` None; the chunkwise form where
    ``cfg.mlstm_chunk`` is set and T exceeds it, else the parallel one) or
    one token against the cache, which is written in place and
    returned."""
    di = params["skip"].shape[0]
    up = torch.matmul(x, params["up_proj"])
    xi_raw, z = up[..., :di], up[..., di:]

    if cache is None:
        xi = silu(_conv_causal(params["conv_w"], params["conv_b"], xi_raw,
                               None))
        q, k, v, i_pre, f_pre = _qkv_gates(params, xi)
        if cfg.mlstm_chunk and x.shape[1] > cfg.mlstm_chunk:
            hout, _, _ = _mlstm_chunked(q, k, v, i_pre, f_pre,
                                        cfg.mlstm_chunk)
        else:
            hout = _mlstm_parallel(q, k, v, i_pre, f_pre)
    else:
        conv_win = torch.cat([cache["conv"], xi_raw], dim=1)
        xi = silu(torch.einsum("bki,ki->bi", conv_win, params["conv_w"])
                  + params["conv_b"])[:, None, :]
        q, k, v, i_pre, f_pre = _qkv_gates(params, xi)
        dh = q.shape[3]
        kf, vf = k[:, 0].float(), v[:, 0].float()
        m_new = _mlstm_update(cache, kf, vf, i_pre[:, 0], f_pre[:, 0])
        qf = q[:, 0].float() * dh ** -0.5
        num = torch.einsum("bhk,bhkj->bhj", qf, cache["c"])
        den = torch.maximum(
            torch.einsum("bhk,bhk->bh", qf, cache["n"]).abs(),
            torch.exp(-m_new))
        hout = (num / (den[..., None] + 1e-6))[:, None]     # [B,1,H,dh]
        cache["conv"].copy_(conv_win[:, 1:])

    hout = groupnorm_heads(hout).to(x.dtype)
    b, t = x.shape[:2]
    hflat = reshape(hout, b, t, di) + params["skip"] * xi
    y = hflat * silu(z)
    return torch.matmul(y, params["down_proj"]), cache


def _mlstm_recurrence(cache: dict, kf: torch.Tensor, vf: torch.Tensor,
                      i_pre: torch.Tensor, f_pre: torch.Tensor) -> None:
    """:func:`_mlstm_update` for each of the T steps of kf/vf [B, T, H, dh]
    f32 and the gates [B, T, H], into ``cache`` in place.  A DTensor's
    shards run it on a local copy of the state, batch and heads as they
    are sharded, which is then copied into the cache; on meta tensors (the
    dry run) the steps are not run and their bytes are reported as
    ``kernels._shard`` reports a kernel's (elementwise: no products)."""
    if _shard.is_dtensor(kf):
        def local(c, n, m, kf, vf, i_pre, f_pre):
            st = {"c": c.clone(), "n": n.clone(), "m": m.clone()}
            _mlstm_recurrence(st, kf, vf, i_pre, f_pre)
            return st["c"], st["n"], st["m"]

        state = _shard.local_call(
            local, (cache["c"], cache["n"], cache["m"], kf, vf, i_pre,
                    f_pre),
            ((0, 1), (0, 1), (0, 1), (0, 2), (0, 2), (0, 2), (0, 2)),
            ((0, 1), (0, 1), (0, 1)))
        for name, val in zip(("c", "n", "m"), state):
            cache[name].copy_(val)
        return
    if kf.device.type == "meta":
        bsz, t, h, dh = kf.shape
        c_bytes, n_bytes = 4 * bsz * h * dh * dh, 4 * bsz * h * dh
        # c scaled and summed in place with an outer product, n likewise,
        # a dozen [B, H] gate ops
        step = 6 * c_bytes + 2 * 4 * n_bytes + 12 * 4 * bsz * h
        _shard.meta_launch("mlstm_recurrence", 0.0, t * step)
        return
    for t in range(kf.shape[1]):
        _mlstm_update(cache, kf[:, t], vf[:, t], i_pre[:, t], f_pre[:, t])


def fill_mlstm_cache(params: dict, h: torch.Tensor, cache: dict) -> dict:
    """Prefill: run the recurrence token by token over the normed prompt
    ``h`` from the fresh cache's state, and keep the conv tail (the last
    K-1 raw up-projected inputs, zero-padded in front)."""
    di = params["skip"].shape[0]
    xi_raw = torch.matmul(h, params["up_proj"])[..., :di]
    xi = silu(_conv_causal(params["conv_w"], params["conv_b"], xi_raw, None))
    _, k, v, i_pre, f_pre = _qkv_gates(params, xi)
    _mlstm_recurrence(cache, k.float(), v.float(), i_pre, f_pre)
    kk = params["conv_w"].shape[0] - 1
    tail = xi_raw[:, max(0, xi_raw.shape[1] - kk):]
    cache["conv"].zero_()
    if kk and tail.shape[1]:
        cache["conv"][:, kk - tail.shape[1]:] = tail.to(cache["conv"].dtype)
    return cache


# =========================================================================== #
# sLSTM                                                                       #
# =========================================================================== #


def slstm_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    df = int(cfg.xlstm.ffn_proj_factor * d)
    dev = generator.device
    bias = torch.zeros((4, h, dh), dtype=torch.float32, device=dev)
    bias[1] = 3.0                                      # forget-gate bias > 0
    return {
        "w": dense_init(generator, d, 4, h, dh, dtype=dtype),  # i, f, z, o
        "r": normal_init(generator, (4, h, dh, dh), dh ** -0.5, dtype),
        "b": bias,
        "ffn_gate": dense_init(generator, d, 2 * df, dtype=dtype),
        "ffn_down": dense_init(generator, df, d, dtype=dtype),
    }


def slstm_axes(cfg: ModelConfig) -> dict:
    return {
        "w": ("embed", "gates", "heads", "head_dim"),
        "r": ("gates", "heads", "head_dim", "head_dim2"),
        "b": ("gates", "heads", "head_dim"),
        "ffn_gate": ("embed", "ff"),
        "ffn_down": ("ff", "embed"),
    }


def init_slstm_cache(batch: int, cfg: ModelConfig,
                     device: torch.device) -> dict:
    """The scan's zero state (h, c, n, m) = (0, 0, 1, 0), each [B, H, dh]
    f32."""
    h = cfg.n_heads
    dh = cfg.d_model // h
    shape, f32 = (batch, h, dh), torch.float32
    return {
        "h": torch.zeros(shape, dtype=f32, device=device),
        "c": torch.zeros(shape, dtype=f32, device=device),
        "n": torch.ones(shape, dtype=f32, device=device),
        "m": torch.zeros(shape, dtype=f32, device=device),
    }


def slstm_cache_axes() -> dict:
    return {
        "h": ("batch", "heads", "head_dim"),
        "c": ("batch", "heads", "head_dim"),
        "n": ("batch", "heads", "head_dim"),
        "m": ("batch", "heads", "head_dim"),
    }


def slstm_apply(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """One ``slstm_scan`` call over x's T steps: from the zero state
    (``cache`` None), or from the cache's state, which then receives the
    state after the last step in place (one step per decode token; a fresh
    cache over the whole prompt in prefill)."""
    b, t, d = x.shape
    heads = cfg.n_heads
    dh = d // heads
    wx = reshape(torch.matmul(x, reshape(params["w"], d, -1)), b, t, 4, heads,
                 dh)
    if cache is None:
        hs, _ = slstm_scan(wx, params["r"], params["b"])
    else:
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
        hs, _ = slstm_scan(wx, params["r"], params["b"], state,
                           out_state=state)
    hs = reshape(groupnorm_heads(hs).to(x.dtype), b, t, d)
    y = x + hs                                          # residual core
    # gated FFN (proj factor 4/3)
    gu = torch.matmul(y, params["ffn_gate"])
    df = gu.shape[-1] // 2
    y2 = silu(gu[..., :df]) * gu[..., df:]
    return torch.matmul(y2, params["ffn_down"]), cache
