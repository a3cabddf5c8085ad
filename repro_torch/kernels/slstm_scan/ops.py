"""Wrapper of the sLSTM scan kernel (``csrc/slstm_scan.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``slstm_scan.launches`` counts kernel launches.  The kernel has no
backward yet: on inputs off the CPU that require grad (grad mode on) the
wrapper raises, so xLSTM trains on the CPU only.

The kernel runs one thread-block cluster per (head, batch row): its CTAs
split the state columns, and exchange h once a step in distributed shared
memory.  :func:`plan_scan` is that split, and how many rows of R each CTA
keeps in shared memory.  The kernel's function attributes are set once
per device, and the card is asked once per plan whether it can place a
cluster of that size (it raises if not).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from .. import _build
from .ref import State, slstm_scan_ref

NAME = "slstm_scan"
MAX_DH = 1024               # kMaxDh in the kernel
MAX_CLUSTER = 16            # kMaxCluster: CTAs a cluster (non-portable > 8)
MAX_COLS = 64               # kMaxCols: state columns a CTA owns at most
SLICES = 8                  # kSlices: k slices, each summed by one thread
SMEM_LIMIT = 232448         # kMaxSmem: dynamic shared memory a CTA (227 KB)
MIN_COLS = 32               # columns a CTA owns before the cluster grows
REG_ROWS = 32               # R rows a thread of the 256-thread build keeps
                            # in registers, either dtype (none at 512)

# slstm_scan_launch: wx, r, bias, h0, c0, n0, m0, hs, h_out, c_out, n_out,
# m_out; B, T, H, dh, dtype, n_cta, cols, rps, smem; stream
ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# slstm_scan_max_clusters: dtype, n_cta, cols, smem; int out
MAX_CLUSTERS_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]

_lib_fns = None
_set_up: set[tuple[int, int]] = set()           # (device, dtype code)
_max_clusters: dict[tuple, int] = {}            # (device, code, plan) -> n


class ScanPlan(NamedTuple):
    n_cta: int                      # CTAs a cluster, one cluster a (head, row)
    cols: int                       # state columns a CTA (the last ragged)
    threads: int                    # SLICES x cols rounded up to a warp
    grid: tuple[int, int, int]      # (n_cta, H, B)
    register_rows: int              # R rows a k slice keeps in registers
    rows_per_slice: int             # then in shared memory (rps)
    resident_rows: int              # of dh, in registers or shared memory
    streamed_rows: int              # of dh, read from memory every step
    smem_bytes: int                 # dynamic shared memory a CTA


def slices(dh: int) -> list[tuple[int, int]]:
    """The kernel's k slices [start, stop): they depend on dh alone."""
    kc = -(-dh // SLICES)
    return [(min(dh, s * kc), min(dh, s * kc + kc)) for s in range(SLICES)]


def smem_bytes(dh: int, cols: int, rps: int, elem: int) -> int:
    """Two mbarriers, h[2][dh] and two sets of partial sums in f32, then R's
    shared-memory rows (``smem_bytes`` in the kernel)."""
    cp = -(-cols // 32) * 32
    return (16 + 2 * (-(-dh // 4) * 4) * 4 + 2 * SLICES * 4 * cp * 4
            + SLICES * rps * 4 * cp * elem)


@functools.lru_cache(maxsize=256)
def plan_scan(b: int, t: int, heads: int, dh: int, dtype: torch.dtype,
              n_cta: Optional[int] = None) -> ScanPlan:
    """Columns split over ``n_cta`` CTAs: by default one CTA per
    ``MIN_COLS`` columns, at most ``MAX_CLUSTER`` (16 at dh=512: 32 columns
    each), none left empty.  Each k slice keeps its first rows in registers
    (32, where a CTA has 32 columns or fewer) and as
    many of the next ones in shared memory as fit, copied in once a call
    (at T=1 that is the one read, all in flight at once); the rest are read
    from memory every step.
    ``n_cta`` overrides the cluster size (the results do not depend on
    it)."""
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"{NAME}: head dim {dh} outside 1..{MAX_DH}")
    if n_cta is None:
        n_cta = min(MAX_CLUSTER, -(-dh // MIN_COLS))
    cols = -(-dh // n_cta)
    if not 1 <= n_cta <= MAX_CLUSTER or cols > MAX_COLS or \
            -(-dh // cols) != n_cta:
        raise ValueError(f"{NAME}: {n_cta} CTAs cannot split {dh} columns "
                         f"(at most {MAX_CLUSTER} CTAs of {MAX_COLS} "
                         "columns, none empty)")
    elem = torch.finfo(dtype).bits // 8
    cp = -(-cols // 32) * 32
    kc = -(-dh // SLICES)
    reg = REG_ROWS if cp == 32 else 0
    fixed = smem_bytes(dh, cols, 0, elem)
    rps = min(max(0, kc - reg), (SMEM_LIMIT - fixed)
              // (SLICES * 4 * cp * elem))
    resident = sum(min(reg + rps, stop - start) for start, stop in slices(dh))
    return ScanPlan(n_cta, cols, SLICES * cp, (n_cta, heads, b), reg, rps,
                    resident, dh - resident, smem_bytes(dh, cols, rps, elem))


def _lib():
    global _lib_fns
    if _lib_fns is None:
        lib = _build.load(NAME)
        launch = lib.slstm_scan_launch
        launch.argtypes = ARGTYPES
        launch.restype = ctypes.c_int
        setup = lib.slstm_scan_setup
        setup.argtypes = [ctypes.c_int]
        setup.restype = ctypes.c_int
        clusters = lib.slstm_scan_max_clusters
        clusters.argtypes = MAX_CLUSTERS_ARGTYPES
        clusters.restype = ctypes.c_int
        _lib_fns = (launch, setup, clusters)
    return _lib_fns


def max_active_clusters(plan: ScanPlan, dtype: torch.dtype,
                        device: torch.device) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan`` on ``device``, asked
    once per plan after the kernel's attributes are set (once per device);
    raises if the card cannot place one such cluster, or if the first ask
    comes during CUDA-graph capture."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    code = _build.DTYPE_CODES[dtype]
    key = (idx, code, plan.n_cta, plan.cols, plan.smem_bytes)
    n = _max_clusters.get(key)
    if n is not None:
        return n
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{NAME}: call once outside CUDA-graph capture "
                           f"with this plan {plan} before capturing")
    _, setup, clusters = _lib()
    with torch.cuda.device(idx):
        if (idx, code) not in _set_up:
            _build.check(setup(code), NAME)
            _set_up.add((idx, code))
        out = ctypes.c_int(0)
        _build.check(clusters(code, plan.n_cta, plan.cols, plan.smem_bytes,
                              ctypes.addressof(out)), NAME)
    if out.value < 1:
        raise RuntimeError(
            f"{NAME}: cuda:{idx} cannot place one cluster of {plan.n_cta} "
            f"CTAs x {plan.threads} threads with {plan.smem_bytes} bytes of "
            f"shared memory each (cudaOccupancyMaxActiveClusters = "
            f"{out.value})")
    _max_clusters[key] = out.value
    return out.value


def slstm_scan(
    wx: torch.Tensor,                     # [B, T, 4, H, dh]
    r: torch.Tensor,                      # [4, H, dh, dh]
    b: torch.Tensor,                      # [4, H, dh]
    state: Optional[Sequence[torch.Tensor]] = None,
    *,
    out_state: Optional[Sequence[torch.Tensor]] = None,
    n_cta: Optional[int] = None,
) -> tuple[torch.Tensor, State]:
    """sLSTM recurrence over T steps -> (hs [B, T, H, dh] f32, final
    (h, c, n, m) each [B, H, dh] f32).

    ``state`` is the carry before step 0 (None: (0, 0, 1, 0), as the Pallas
    kernel starts); with ``out_state`` the final state is written into those
    tensors, which may be ``state`` itself (an in-place cache update).
    ``n_cta`` overrides the plan's cluster size on the card."""
    if wx.device.type == "cpu":
        return slstm_scan_ref(wx, r, b, state, out_state=out_state)
    _build.refuse_grad(NAME, wx, r, b, *(state or ()))
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
    plan = plan_scan(bsz, t, heads, dh, wx.dtype, n_cta)
    max_active_clusters(plan, wx.dtype, wx.device)
    hs = torch.empty((bsz, t, heads, dh), dtype=torch.float32,
                     device=wx.device)
    ptrs = [s.data_ptr() for s in ins] if ins else [None] * 4
    launch, _, _ = _lib()
    with torch.cuda.device(wx.device):
        err = launch(
            wx.data_ptr(), r.data_ptr(), b.data_ptr(), *ptrs, hs.data_ptr(),
            *(s.data_ptr() for s in outs), bsz, t, heads, dh,
            _build.DTYPE_CODES[wx.dtype], plan.n_cta, plan.cols,
            plan.rows_per_slice, plan.smem_bytes,
            torch.cuda.current_stream(wx.device).cuda_stream)
    _build.check(err, NAME)
    slstm_scan.launches += 1
    return hs, outs


slstm_scan.launches = 0
