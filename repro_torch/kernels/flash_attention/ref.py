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
