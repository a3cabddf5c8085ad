"""Plain PyTorch versions of GQA attention: the parity oracle of the flash
kernel, and the path that CPU tensors take."""
from __future__ import annotations

import torch

from ...models.layers.common import masked_softmax


def gqa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """q [B,T,H,D], k/v [B,S,KV,D], mask [B|1, 1, T, S] -> [B,T,H,D].

    Query head h reads KV head h // (H // KV).  Math in f32, output in the
    dtype of q; a row with no valid key gives 0.
    """
    b, t, h, d = q.shape
    kv = k.shape[2]
    group = h // kv
    qf = q.float().reshape(b, t, kv, group, d)
    scale = d ** -0.5
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * scale
    w = masked_softmax(scores, mask[:, :, None])      # [B,1,1,T,S] broadcast
    out = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """The flash kernel's function: q [B,T,H,D], k/v [B,S,KV,D], absolute
    positions q_pos [T] and k_pos [S]; causal (optionally windowed) or
    unmasked attention."""
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
    else:
        mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                          device=q.device)
    return gqa_attention_ref(q, k, v, mask[None, None])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q/k/v [B, H, T, D] -> [B, H, T, D], the JAX package's attention
    oracle: :func:`flash_attention_ref` at positions 0..T-1 in the model's
    layout, causal (optionally windowed) or unmasked (``window`` ignored).
    Math in f32, output in the dtype of q."""
    p = torch.arange(q.shape[2], dtype=torch.int32, device=q.device)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), p, p, causal=causal,
                              window=window)
    return out.transpose(1, 2)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_pos: torch.Tensor,
                            k_pos: torch.Tensor, out: torch.Tensor,
                            d_out: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The backward kernel's function: (dq, dk, dv) of
    :func:`flash_attention_ref` for the upstream gradient ``d_out``, with
    ``out`` the forward's output.  Written out: P recomputed from the
    scores, delta = rowsum(dO * O), dS = P * (dP - delta), dQ = scale dS K,
    dK = scale dS^T Q and dV = P^T dO, dK and dV summed over the G query
    heads of each KV head; scale = 1/sqrt(D).  A row with no valid key
    (P = 0) gets zero gradients.  Math in f32, outputs in the inputs'
    dtypes."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    shape = (b, t, kv, g, d)
    qf, of = q.float().reshape(shape), out.float().reshape(shape)
    dof = d_out.float().reshape(shape)
    kf, vf = k.float(), v.float()
    scale = d ** -0.5
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
    else:
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, kf) * scale
    p = masked_softmax(scores, mask)                     # [B, KV, G, T, S]
    dp = torch.einsum("btkgd,bskd->bkgts", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgts,btkgd->bskd", p, dof)
    return (dq.reshape(b, t, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
