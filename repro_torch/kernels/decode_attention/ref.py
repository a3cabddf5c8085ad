"""Plain PyTorch version of single-token GQA decode attention over a
position-tracked (optionally rotating) KV cache: the parity oracle of the
decode kernel, and the path that CPU tensors take."""
from __future__ import annotations

import torch

from ..flash_attention.ref import gqa_attention_ref


def decode_attention_ref(
    q: torch.Tensor,            # [B, H, D] one token of queries
    k_cache: torch.Tensor,      # [B, S, KV, D]
    v_cache: torch.Tensor,
    positions: torch.Tensor,    # [B, S] absolute stored positions (-1 empty)
    pos: int,                   # current absolute position
    *,
    window: int = 0,
) -> torch.Tensor:
    """-> [B, H, D]; a slot is valid when 0 <= stored <= pos and, with a
    window, stored > pos - window.  A head with no valid slot gives 0."""
    valid = (positions >= 0) & (positions <= pos)
    if window > 0:
        valid &= positions > pos - window
    out = gqa_attention_ref(q[:, None], k_cache, v_cache,
                            valid[:, None, None, :])
    return out[:, 0]
