"""Wrapper of the sLSTM scan kernel (``csrc/slstm_scan.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``slstm_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import _build
from .ref import State, slstm_scan_ref

NAME = "slstm_scan"
MAX_DH = 1024                  # one thread of the CTA per state column


def _launcher():
    fn = _build.load(NAME).slstm_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def slstm_scan(
    wx: torch.Tensor,                     # [B, T, 4, H, dh]
    r: torch.Tensor,                      # [4, H, dh, dh]
    b: torch.Tensor,                      # [4, H, dh]
    state: Optional[Sequence[torch.Tensor]] = None,
    *,
    out_state: Optional[Sequence[torch.Tensor]] = None,
) -> tuple[torch.Tensor, State]:
    """sLSTM recurrence over T steps -> (hs [B, T, H, dh] f32, final
    (h, c, n, m) each [B, H, dh] f32).

    ``state`` is the carry before step 0 (None: (0, 0, 1, 0), as the Pallas
    kernel starts); with ``out_state`` the final state is written into those
    tensors, which may be ``state`` itself (an in-place cache update)."""
    if wx.device.type == "cpu":
        return slstm_scan_ref(wx, r, b, state, out_state=out_state)
    bsz, t, four, heads, dh = wx.shape
    b = b.float().contiguous()
    outs = tuple(out_state) if out_state is not None else tuple(
        torch.empty((bsz, heads, dh), dtype=torch.float32, device=wx.device)
        for _ in range(4))
    ins = tuple(state) if state is not None else ()
    _build.check_inputs(
        NAME, (wx, r), f32s=(b, *ins, *outs),
        shapes_ok=(four == 4 and t >= 1 and r.shape == (4, heads, dh, dh)
                   and b.shape == (4, heads, dh) and len(outs) == 4
                   and len(ins) in (0, 4)
                   and all(s.shape == (bsz, heads, dh)
                           for s in (*ins, *outs))),
        head_dim=dh, max_head_dim=MAX_DH)
    hs = torch.empty((bsz, t, heads, dh), dtype=torch.float32,
                     device=wx.device)
    ptrs = [s.data_ptr() for s in ins] if ins else [None] * 4
    with torch.cuda.device(wx.device):
        err = _launcher()(
            wx.data_ptr(), r.data_ptr(), b.data_ptr(), *ptrs, hs.data_ptr(),
            *(s.data_ptr() for s in outs), bsz, t, heads, dh,
            _build.DTYPE_CODES[wx.dtype],
            torch.cuda.current_stream(wx.device).cuda_stream)
    _build.check(err, NAME)
    slstm_scan.launches += 1
    return hs, outs


slstm_scan.launches = 0
