"""Plain PyTorch version of the sLSTM scan and of its backward: the parity
oracles of the scan kernels, and the path that CPU tensors take.

Same arithmetic as the JAX package's ``slstm_scan_ref`` and the Pallas
kernel (R and the bias cast to f32, state in f32), over a carry that may
start from a given state and whose final value is returned.  The backward
is the gradient JAX takes of ``lax.scan`` over ``_slstm_step``, written as
a reverse scan: both maxima pass half the gradient to each side on an
exact tie, as ``jnp.maximum`` does, and the stabiliser ``m`` carries a
gradient (JAX stops none).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

State = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# What the backward reads of a forward: the f32 pre-activations
# pre [B, T, 4, H, dh] and the state (c, n, m) after every step, each
# [B, T, H, dh] (h after every step is hs).
Saved = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
N_FLOOR = 1e-6                  # n's floor: n_t = max(f' n + i', 1e-6)


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
    n_new = torch.clamp(f_eff * n + i_eff, min=N_FLOOR)
    h_new = torch.sigmoid(o_pre) * c_new / n_new
    return h_new, c_new, n_new, m_new


def _scan(wx, r, b, state, save: bool):
    bsz, t, _, heads, dh = wx.shape
    if state is None:
        state = _zero_state(bsz, heads, dh, wx.device)
    st = tuple(s.float() for s in state)
    rf, bf = r.float(), b.float()
    hs, pres, cs, ns, ms = [], [], [], [], []
    for i in range(t):
        rec = torch.einsum("bhk,ghkj->bghj", st[0], rf)
        pre = wx[:, i].float() + rec + bf
        st = _step(st, pre)
        hs.append(st[0])
        if save:
            pres.append(pre)
            cs.append(st[1])
            ns.append(st[2])
            ms.append(st[3])
    saved = tuple(torch.stack(x, dim=1) for x in (pres, cs, ns, ms)) \
        if save else None
    return torch.stack(hs, dim=1), st, saved


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
    out, st, _ = _scan(wx, r, b, state, save=False)
    if out_state is not None:
        for dst, src in zip(out_state, st):
            dst.copy_(src)
        st = tuple(out_state)
    return out, st


def slstm_scan_saving_ref(
    wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
    state: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, State, Saved]:
    """:func:`slstm_scan_ref` that also returns what the backward reads:
    (hs, final state, (pre, c, n, m) of every step)."""
    return _scan(wx, r, b, state, save=True)


def _max_share(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d max(x, y) / dx as ``jnp.maximum``: 1 where x > y, 1/2 on a tie."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def _gate_bwd(pre: torch.Tensor, prev: tuple, dh: torch.Tensor,
             carry: tuple) -> tuple[torch.Tensor, tuple]:
    """One step of the reverse scan.  ``pre`` [B, 4, H, dh] f32 is the
    step's pre-activations, ``prev`` the state (c, n, m) before it, ``dh``
    the gradient of its h, ``carry`` that of its (c, n, m) from the later
    steps.  -> (dpre [B, 4, H, dh], the gradient of ``prev``)."""
    c_prev, n_prev, m_prev = prev
    dc, dn, dm = carry
    i_pre, f_pre, z_pre, o_pre = pre.unbind(1)
    a = F.logsigmoid(f_pre) + m_prev
    m_new = torch.maximum(a, i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(a - m_new)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c_new = f_eff * c_prev + i_eff * z
    u = f_eff * n_prev + i_eff
    n_new = torch.clamp(u, min=N_FLOOR)
    # h = o c / n
    d_o = dh * c_new / n_new
    dc = dc + dh * o / n_new
    dn = dn - dh * o * c_new / (n_new * n_new)
    du = dn * _max_share(u, torch.full_like(u, N_FLOOR))
    d_i_eff = (dc * z + du) * i_eff         # through exp(i_pre - m_new)
    d_f_eff = (dc * c_prev + du * n_prev) * f_eff    # exp(a - m_new)
    dm = dm - d_i_eff - d_f_eff
    share = _max_share(a, i_pre)            # m_new = max(a, i_pre)
    da = d_f_eff + dm * share
    d_i = d_i_eff + dm * (1.0 - share)
    dpre = torch.stack([d_i, da * torch.sigmoid(-f_pre),
                        dc * i_eff * (1.0 - z * z), d_o * o * (1.0 - o)],
                       dim=1)
    return dpre, (dc * f_eff, du * f_eff, da)


def param_grads(h0: Optional[torch.Tensor], hs: torch.Tensor,
                dpre: torch.Tensor, r_dtype: torch.dtype,
                b_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """dR[g,h,k,j] = sum over (b, t) of h_{t-1}[b,h,k] dpre_t[b,g,h,j]
    (h_{-1} = h0, None for the zero state) and db = sum of dpre, in f32,
    returned in R's and the bias's dtypes."""
    first = torch.zeros_like(hs[:, :1]) if h0 is None else h0[:, None]
    h_prev = torch.cat([first, hs[:, :-1]], dim=1)
    dr = torch.einsum("bthk,btghj->ghkj", h_prev, dpre)
    return dr.to(r_dtype), dpre.sum((0, 1)).to(b_dtype)


def slstm_scan_bwd_ref(
    r: torch.Tensor,                      # [4, H, dh, dh]
    b: torch.Tensor,                      # [4, H, dh]
    state: Optional[Sequence[torch.Tensor]],
    hs: torch.Tensor,                     # [B, T, H, dh] f32
    saved: Saved,
    dhs: torch.Tensor,                    # [B, T, H, dh] f32
    d_state: Optional[Sequence[torch.Tensor]] = None,
    *,
    wx_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, State]:
    """Gradients of a scan from ``state`` (None: the zero state) whose
    forward gave ``hs`` and ``saved``: ``dhs`` is the gradient of hs,
    ``d_state`` that of the final (h, c, n, m) (None: zero).
    -> (dwx in ``wx_dtype``, dR, db in their dtypes, the gradient of the
    initial (h, c, n, m) in f32)."""
    pre, cs, ns, ms = saved
    bsz, t, _, heads, dh = pre.shape
    first = state if state is not None else \
        _zero_state(bsz, heads, dh, pre.device)
    rf = r.float()
    if d_state is None:
        z = torch.zeros((bsz, heads, dh), device=pre.device)
        d_state = (z, z, z, z)
    dh_next = d_state[0].float()
    carry = tuple(x.float() for x in d_state[1:])
    dpre = torch.empty_like(pre)
    for i in reversed(range(t)):
        prev = (cs[:, i - 1], ns[:, i - 1], ms[:, i - 1]) if i > 0 else \
            tuple(x.float() for x in first[1:])
        dpre[:, i], carry = _gate_bwd(pre[:, i], prev,
                                     dhs[:, i].float() + dh_next, carry)
        dh_next = torch.einsum("bghj,ghkj->bhk", dpre[:, i], rf)
    h0 = state[0].float() if state is not None else None
    dr, db = param_grads(h0, hs, dpre, r.dtype, b.dtype)
    return dpre.to(wx_dtype), dr, db, (dh_next, *carry)
