"""Plain PyTorch version of the sLSTM scan: the parity oracle of the scan
kernel, and the path that CPU tensors take.

Same arithmetic as the JAX package's ``slstm_scan_ref`` and the Pallas
kernel (R and the bias cast to f32, state in f32), over a carry that may
start from a given state and whose final value is returned.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _zero_state(bsz: int, heads: int, dh: int,
                device: torch.device) -> State:
    """The scan's start (h, c, n, m) = (0, 0, 1, 0), each [B, H, dh] f32."""
    z = torch.zeros((bsz, heads, dh), dtype=torch.float32, device=device)
    return z, z.clone(), torch.ones_like(z), z.clone()


def _step(state: State, pre: torch.Tensor) -> State:
    """One step of exponential gating from the f32 pre-activations
    ``pre [B, 4, H, dh]`` (gates i, f, z, o)."""
    h, c, n, m = state
    i_pre, f_pre, z_pre, o_pre = pre.unbind(1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(logf + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(z_pre)
    n_new = torch.clamp(f_eff * n + i_eff, min=1e-6)
    h_new = torch.sigmoid(o_pre) * c_new / n_new
    return h_new, c_new, n_new, m_new


def slstm_scan_ref(
    wx: torch.Tensor,                     # [B, T, 4, H, dh]
    r: torch.Tensor,                      # [4, H, dh, dh]
    b: torch.Tensor,                      # [4, H, dh]
    state: Optional[Sequence[torch.Tensor]] = None,
    *,
    out_state: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, State]:
    """-> (hs [B, T, H, dh] f32, final (h, c, n, m) each [B, H, dh] f32).

    ``state`` is the carry before step 0 (None: the zero state).  With
    ``out_state`` the final state is copied into those tensors, which may be
    ``state`` itself, and they are returned."""
    bsz, t, _, heads, dh = wx.shape
    if state is None:
        state = _zero_state(bsz, heads, dh, wx.device)
    st = tuple(s.float() for s in state)
    rf, bf = r.float(), b.float()
    hs = []
    for i in range(t):
        rec = torch.einsum("bhk,ghkj->bghj", st[0], rf)
        st = _step(st, wx[:, i].float() + rec + bf)
        hs.append(st[0])
    out = torch.stack(hs, dim=1)
    if out_state is not None:
        for dst, src in zip(out_state, st):
            dst.copy_(src)
        st = tuple(out_state)
    return out, st
