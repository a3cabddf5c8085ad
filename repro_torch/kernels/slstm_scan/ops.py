"""Wrappers of the sLSTM scan kernel (``csrc/slstm_scan.cu``) and of its
backward (``csrc/slstm_scan_bwd.cu``).

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  ``slstm_scan.launches`` counts forward launches,
``slstm_scan_bwd.launches`` backward ones.  Where grad mode is on and an
input requires grad, ``slstm_scan`` runs through :class:`SLSTMScanFn`:
its forward launches the kernel in its saving mode (the pre-activations
and the state after every step are also written out), its backward the
backward kernel (the plain versions for CPU tensors).

Both kernels run one thread-block cluster per (head, batch row): its CTAs
split the state columns, and exchange a vector once a step in distributed
shared memory (the forward h, the backward each column's four gate
gradients).  :func:`plan_scan` is that split, and how many rows of R each
CTA keeps in registers and shared memory, for either kernel.  The kernels'
function attributes are set once per device, and the card is asked once
per plan whether it can place a cluster of that size (it raises if not).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from .. import _build, _shard
from .ref import (State, Saved, param_grads, slstm_scan_bwd_ref,
                  slstm_scan_ref, slstm_scan_saving_ref)

NAME = "slstm_scan"
BWD_NAME = "slstm_scan_bwd"
MAX_DH = 1024               # kMaxDh in the kernels
MAX_CLUSTER = 16            # kMaxCluster: CTAs a cluster (non-portable > 8)
MAX_COLS = 64               # kMaxCols: state columns a CTA owns at most
SLICES = 8                  # kSlices: k slices, each summed by one thread
SMEM_LIMIT = 232448         # kMaxSmem: dynamic shared memory a CTA (227 KB)
MIN_COLS = 32               # columns a CTA owns before the cluster grows
REG_ROWS = 32               # R rows a thread of the forward's 256-thread
                            # build keeps in registers, either dtype (none
                            # at 512)
BWD_SUBS = 32               # kSubs: the backward's j subslices
BWD_REG_ROWS = 10           # kRegRows: rows of its subslice a thread of
                            # the backward's 256-thread build keeps in
                            # registers, either dtype
BWD_STAGES = 8              # kStages: steps of inputs in the backward's ring
BWD_RUNS = 8                # kRuns: pre's 4 gates, c, n, m, dhs a step
BWD_GATED = 9               # kGated: values a gating thread keeps for dh_t

# slstm_scan_launch: wx, r, bias, h0, c0, n0, m0, hs, h_out, c_out, n_out,
# m_out, pre, c_all, n_all, m_all; B, T, H, dh, dtype, n_cta, cols, rps,
# smem; stream
ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# slstm_scan_max_clusters (and the backward's): dtype, n_cta, cols, smem;
# int out
MAX_CLUSTERS_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
# slstm_scan_bwd_launch: rt, pre, c_all, n_all, m_all, c0, n0, m0, dhs,
# dh_T, dc_T, dn_T, dm_T, dpre, dh0, dc0, dn0, dm0; B, T, H, dh, dtype,
# n_cta, cols, rps, smem; stream
BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + \
    [ctypes.c_void_p]

_lib_fns = None
_set_up: set[tuple] = set()                     # (device, dtype, backward)
_max_clusters: dict[tuple, int] = {}            # (device, ..., plan) -> n


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


def slices(dh: int, n: int = SLICES) -> list[tuple[int, int]]:
    """The forward's k slices [start, stop) (the backward's j subslices
    with ``n=BWD_SUBS``): they depend on dh alone."""
    kc = -(-dh // n)
    return [(min(dh, s * kc), min(dh, s * kc + kc)) for s in range(n)]


def smem_bytes(dh: int, cols: int, rps: int, elem: int) -> int:
    """Two mbarriers, h[2][dh] and two sets of partial sums in f32, then R's
    shared-memory rows (``smem_bytes`` in the kernel)."""
    cp = -(-cols // 32) * 32
    return (16 + 2 * (-(-dh // 4) * 4) * 4 + 2 * SLICES * 4 * cp * 4
            + SLICES * rps * 4 * cp * elem)


def bwd_smem_bytes(dh: int, cols: int, rps: int, elem: int) -> int:
    """The backward's: the mbarriers (two of the exchange and one a ring
    stage, padded to 16 bytes), the four gate gradients of every column
    [2][dh][4], two sets of one partial sum a subslice pair and column, the
    ring of step inputs [stages][runs][cols + 4], the initial state with
    dh's seed [4][cols] and the gating threads' values for dh_t
    [4][gated][cols], in f32, then R^T's shared-memory rows, ``rps`` a
    subslice (``smem_bytes`` in the backward)."""
    cp = -(-cols // 32) * 32
    bars = -(-(2 + BWD_STAGES) * 8 // 16) * 16
    return (bars + 2 * (-(-dh // 4) * 4) * 16 + BWD_SUBS * cp * 4
            + BWD_STAGES * BWD_RUNS * (cp + 4) * 4 + 4 * cp * 4
            + 4 * BWD_GATED * cp * 4
            + BWD_SUBS * rps * 4 * cp * elem)


@functools.lru_cache(maxsize=256)
def plan_scan(b: int, t: int, heads: int, dh: int, dtype: torch.dtype,
              n_cta: Optional[int] = None,
              backward: bool = False) -> ScanPlan:
    """Columns split over ``n_cta`` CTAs: by default one CTA per
    ``MIN_COLS`` columns, at most ``MAX_CLUSTER`` (16 at dh=512: 32 columns
    each), none left empty.  Each k slice keeps its first rows in registers
    (where a CTA has 32 columns or fewer: 32 in the forward) and as many of
    the next ones in shared memory as fit, copied in once a call (at T=1
    that is the one read, all in flight at once); the rest are read from
    memory every step.
    ``n_cta`` overrides the cluster size (the results do not depend on
    it); ``backward`` plans the backward kernel, whose sums run over R's
    columns j (it reads R transposed) in ``BWD_SUBS`` subslices (10 rows of
    each in registers), and whose shared memory holds four floats a column
    where the forward holds h, and the ring of step inputs."""
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
    n = BWD_SUBS if backward else SLICES
    kc = -(-dh // n)
    smem = bwd_smem_bytes if backward else smem_bytes
    reg = 0
    if cp == 32:
        reg = BWD_REG_ROWS if backward else REG_ROWS
    fixed = smem(dh, cols, 0, elem)
    rps = min(max(0, kc - reg), (SMEM_LIMIT - fixed) // (n * 4 * cp * elem))
    resident = sum(min(reg + rps, stop - start)
                   for start, stop in slices(dh, n))
    return ScanPlan(n_cta, cols, SLICES * cp, (n_cta, heads, b), reg, rps,
                    resident, dh - resident, smem(dh, cols, rps, elem))


def _lib():
    """(forward launch, backward launch, {backward: (setup, clusters)})."""
    global _lib_fns
    if _lib_fns is None:
        lib = _build.load(NAME)
        launch = lib.slstm_scan_launch
        launch.argtypes = ARGTYPES
        bwd = lib.slstm_scan_bwd_launch
        bwd.argtypes = BWD_ARGTYPES
        ask = {}
        for backward, prefix in ((False, NAME), (True, BWD_NAME)):
            setup = getattr(lib, f"{prefix}_setup")
            setup.argtypes = [ctypes.c_int]
            clusters = getattr(lib, f"{prefix}_max_clusters")
            clusters.argtypes = MAX_CLUSTERS_ARGTYPES
            ask[backward] = (setup, clusters)
        for fn in (launch, bwd, *(f for pair in ask.values() for f in pair)):
            fn.restype = ctypes.c_int
        _lib_fns = (launch, bwd, ask)
    return _lib_fns


def max_active_clusters(plan: ScanPlan, dtype: torch.dtype,
                        device: torch.device, backward: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan`` on ``device`` (of the
    backward kernel with ``backward``), asked once per plan after the
    kernel's attributes are set (once per device); raises if the card
    cannot place one such cluster, or if the first ask comes during
    CUDA-graph capture."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    code = _build.DTYPE_CODES[dtype]
    key = (idx, code, backward, plan.n_cta, plan.cols, plan.smem_bytes)
    n = _max_clusters.get(key)
    if n is not None:
        return n
    name = BWD_NAME if backward else NAME
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{name}: call once outside CUDA-graph capture "
                           f"with this plan {plan} before capturing")
    setup, clusters = _lib()[2][backward]
    with torch.cuda.device(idx):
        if (idx, code, backward) not in _set_up:
            _build.check(setup(code), name)
            _set_up.add((idx, code, backward))
        out = ctypes.c_int(0)
        _build.check(clusters(code, plan.n_cta, plan.cols, plan.smem_bytes,
                              ctypes.addressof(out)), name)
    if out.value < 1:
        raise RuntimeError(
            f"{name}: cuda:{idx} cannot place one cluster of {plan.n_cta} "
            f"CTAs x {plan.threads} threads with {plan.smem_bytes} bytes of "
            f"shared memory each (cudaOccupancyMaxActiveClusters = "
            f"{out.value})")
    _max_clusters[key] = out.value
    return out.value


def _f32(dev, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _forward(wx, r, b, state, out_state, n_cta, save: bool):
    """The plain version for CPU tensors; else one launch of the kernel.
    -> (hs, final state, saved or None)."""
    if wx.device.type == "cpu":
        if save:
            return slstm_scan_saving_ref(wx, r, b, state)
        return (*slstm_scan_ref(wx, r, b, state, out_state=out_state), None)
    bsz, t, four, heads, dh = wx.shape
    b = b.float().contiguous()
    dev = wx.device
    outs = tuple(out_state) if out_state is not None else tuple(
        _f32(dev, bsz, heads, dh) for _ in range(4))
    ins = tuple(state) if state is not None else ()
    if dev.type == "meta":
        hs = _f32(dev, bsz, t, heads, dh)
        saved = (_f32(dev, bsz, t, 4, heads, dh),
                 *(_f32(dev, bsz, t, heads, dh) for _ in range(3))) \
            if save else None
        # the product's multiply-adds and about 20 operations of gating a
        # state element and step; each input read once, each output
        # (the saving mode's too) written once
        _shard.meta_launch(NAME, 2.0 * bsz * t * 4 * heads * dh * dh
                           + 20.0 * bsz * t * heads * dh,
                           _shard.nbytes(wx, r, b, *ins, hs, *outs,
                                         *(saved or ())))
        return hs, outs, saved
    _build.check_inputs(
        NAME, (wx, r), f32s=(b, *ins, *outs),
        shapes_ok=(four == 4 and t >= 1 and r.shape == (4, heads, dh, dh)
                   and b.shape == (4, heads, dh) and len(outs) == 4
                   and len(ins) in (0, 4)
                   and all(s.shape == (bsz, heads, dh)
                           for s in (*ins, *outs))),
        head_dim=dh, max_head_dim=MAX_DH)
    plan = plan_scan(bsz, t, heads, dh, wx.dtype, n_cta)
    max_active_clusters(plan, wx.dtype, dev)
    hs = _f32(dev, bsz, t, heads, dh)
    saved = None
    if save:
        saved = (_f32(dev, bsz, t, 4, heads, dh),
                 *(_f32(dev, bsz, t, heads, dh) for _ in range(3)))
    ptrs = [s.data_ptr() for s in ins] if ins else [None] * 4
    save_ptrs = [s.data_ptr() for s in saved] if save else [None] * 4
    with torch.cuda.device(dev):
        err = _lib()[0](
            wx.data_ptr(), r.data_ptr(), b.data_ptr(), *ptrs, hs.data_ptr(),
            *(s.data_ptr() for s in outs), *save_ptrs, bsz, t, heads, dh,
            _build.DTYPE_CODES[wx.dtype], plan.n_cta, plan.cols,
            plan.rows_per_slice, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, NAME)
    slstm_scan.launches += 1
    return hs, outs, saved


def slstm_scan_saving(
    wx: torch.Tensor, r: torch.Tensor, b: torch.Tensor,
    state: Optional[Sequence[torch.Tensor]] = None, *,
    n_cta: Optional[int] = None,
) -> tuple[torch.Tensor, State, Saved]:
    """The forward in its saving mode: (hs, final state, (pre, c, n, m) of
    every step), what :func:`slstm_scan_bwd` reads; one launch of the
    kernel (counted in ``slstm_scan.launches``), or the plain version for
    CPU tensors.  No gradient is recorded."""
    return _forward(wx, r, b, state, None, n_cta, save=True)


def slstm_scan_bwd(
    r: torch.Tensor,                      # [4, H, dh, dh]
    b: torch.Tensor,                      # [4, H, dh]
    state: Optional[Sequence[torch.Tensor]],
    hs: torch.Tensor,                     # [B, T, H, dh] f32
    saved: Saved,
    dhs: torch.Tensor,                    # [B, T, H, dh] f32
    d_state: Optional[Sequence[torch.Tensor]] = None,
    *,
    wx_dtype: torch.dtype = torch.float32,
    n_cta: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, State]:
    """The scan's gradients (as :func:`ref.slstm_scan_bwd_ref`): the plain
    version for CPU tensors; else one launch of the backward kernel, which
    runs the reverse scan and writes the pre-activations' gradient dpre
    (dwx, cast to ``wx_dtype``) and the initial state's, then dR and db as
    a batched product (``torch.einsum``) and a sum over (B, T) of dpre in
    f32.
    ``n_cta`` overrides the plan's cluster size (the results do not
    depend on it)."""
    if r.device.type == "cpu":
        return slstm_scan_bwd_ref(r, b, state, hs, saved, dhs, d_state,
                                  wx_dtype=wx_dtype)
    pre, cs, ns, ms = saved
    bsz, t, four, heads, dh = pre.shape
    dev = r.device
    ins = tuple(state[1:]) if state is not None else ()
    seeds = tuple(d_state) if d_state is not None else ()
    if dev.type == "meta":
        dpre = _f32(dev, bsz, t, 4, heads, dh)
        d0 = tuple(_f32(dev, bsz, heads, dh) for _ in range(4))
        # the launch alone: the reverse scan's products and about 40
        # operations of gating a state element and step; R, what the
        # forward saved, dhs, the state and seeds read, dpre and the
        # initial state's gradient written (dR and db below are counted
        # as the plain products they are)
        _shard.meta_launch(BWD_NAME, 2.0 * 4 * dh * dh * bsz * t * heads
                           + 40.0 * bsz * t * heads * dh,
                           _shard.nbytes(r, *saved, dhs, *ins, *seeds, dpre,
                                         *d0))
        h0 = state[0] if state is not None else None
        dr, db = param_grads(h0, hs, dpre, r.dtype, b.dtype)
        return dpre.to(wx_dtype), dr, db, d0
    # the kernel reads R^T (rt[g, h, j, k] = R[g, h, k, j]) as the forward
    # reads R: coalesced rows, the same register and shared-memory layout
    rt = r.transpose(2, 3).contiguous()
    _build.check_inputs(
        BWD_NAME, (rt,), f32s=(pre, cs, ns, ms, *ins, hs, dhs, *seeds),
        shapes_ok=(four == 4 and t >= 1 and r.shape == (4, heads, dh, dh)
                   and all(x.shape == (bsz, t, heads, dh)
                           for x in (cs, ns, ms, hs, dhs))
                   and len(ins) in (0, 3) and len(seeds) in (0, 4)
                   and all(x.shape == (bsz, heads, dh)
                           for x in (*ins, *seeds))),
        head_dim=dh, max_head_dim=MAX_DH)
    # the kernel's bulk copies read these from 16-byte bounds
    pre, cs, ns, ms, dhs = (x if x.data_ptr() % 16 == 0 else x.clone()
                            for x in (pre, cs, ns, ms, dhs))
    plan = plan_scan(bsz, t, heads, dh, r.dtype, n_cta, backward=True)
    max_active_clusters(plan, r.dtype, dev, backward=True)
    dpre = _f32(dev, bsz, t, 4, heads, dh)
    d0 = tuple(_f32(dev, bsz, heads, dh) for _ in range(4))
    in_ptrs = [x.data_ptr() for x in ins] if ins else [None] * 3
    seed_ptrs = [x.data_ptr() for x in seeds] if seeds else [None] * 4
    with torch.cuda.device(dev):
        err = _lib()[1](
            rt.data_ptr(), *(x.data_ptr() for x in (pre, cs, ns, ms)),
            *in_ptrs,
            dhs.data_ptr(), *seed_ptrs, dpre.data_ptr(),
            *(x.data_ptr() for x in d0), bsz, t, heads, dh,
            _build.DTYPE_CODES[r.dtype], plan.n_cta, plan.cols,
            plan.rows_per_slice, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, BWD_NAME)
    slstm_scan_bwd.launches += 1
    h0 = state[0] if state is not None else None
    dr, db = param_grads(h0, hs, dpre, r.dtype, b.dtype)
    return dpre.to(wx_dtype), dr, db, d0


slstm_scan_bwd.launches = 0


class SLSTMScanFn(torch.autograd.Function):
    """The sLSTM scan with its backward kernel as the gradient: the forward
    saves R, the bias, hs, the initial state and what the saving mode
    writes; the backward launches :func:`slstm_scan_bwd` (its plain
    version for CPU tensors), seeded with the final state's gradients where
    they are given."""

    @staticmethod
    def forward(ctx, wx, r, b, h0, c0, n0, m0, n_cta):
        state = None if h0 is None else (h0, c0, n0, m0)
        hs, final, saved = slstm_scan_saving(wx, r, b, state, n_cta=n_cta)
        ctx.save_for_backward(r, b, hs, *saved, *(state or ()))
        ctx.wx_dtype, ctx.n_cta = wx.dtype, n_cta
        ctx.set_materialize_grads(False)
        return (hs, *final)

    @staticmethod
    def backward(ctx, dhs, *d_final):
        r, b, hs, *rest = ctx.saved_tensors
        saved, state = tuple(rest[:4]), tuple(rest[4:]) or None
        dhs = torch.zeros_like(hs) if dhs is None else dhs.float().contiguous()
        d_state = None
        if any(d is not None for d in d_final):
            d_state = tuple(
                torch.zeros_like(hs[:, 0]) if d is None
                else d.float().contiguous() for d in d_final)
        dwx, dr, db, d0 = slstm_scan_bwd(r, b, state, hs, saved, dhs,
                                         d_state, wx_dtype=ctx.wx_dtype,
                                         n_cta=ctx.n_cta)
        d0 = d0 if state is not None else (None,) * 4
        return dwx, dr, db, *d0, None


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
    (h, c, n, m) each [B, H, dh] f32); differentiable through
    :class:`SLSTMScanFn` where grad mode is on and an input requires grad.

    ``state`` is the carry before step 0 (None: (0, 0, 1, 0), as the Pallas
    kernel starts); with ``out_state`` the final state is written into those
    tensors, which may be ``state`` itself (an in-place cache update, which
    raises under grad).  ``n_cta`` overrides the plan's cluster size on the
    card."""
    ins = tuple(state) if state is not None else (None,) * 4
    grad = torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (wx, r, b, *ins))
    if grad and out_state is not None:
        raise RuntimeError(f"{NAME}: out_state (an in-place state update) "
                           "cannot run on inputs that require grad")
    if _shard.is_dtensor(wx) or _shard.is_dtensor(r):
        return _dtensor_scan(wx, r, b, state, out_state, n_cta)
    if grad:
        hs, *final = SLSTMScanFn.apply(wx, r, b, *ins, n_cta)
        return hs, tuple(final)
    hs, final, _ = _forward(wx, r, b, state, out_state, n_cta, save=False)
    return hs, final


slstm_scan.launches = 0


def slstm_hidden_states(
    wx: torch.Tensor,                     # [B, T, 4, H, dh] (x @ w)
    r: torch.Tensor,                      # [4, H, dh, dh]
    b: torch.Tensor,                      # [4, H, dh]
) -> torch.Tensor:
    """The sLSTM scan's hidden states hs [B, T, H, dh] f32 from the start
    state (0, 0, 1, 0): :func:`slstm_scan` without its final state,
    differentiable as it is.  A test-only parity shim of the JAX adapter of
    the same name; no path of the port calls it.  The kernel runs no padded
    step, so there is no ``block_t``, and the JAX adapter's Pallas switches
    (``use_pallas``, ``interpret``) are not taken: CUDA tensors always
    launch the kernel, CPU tensors take the plain version.  The oracle is
    :func:`.ref.slstm_scan_ref`."""
    return slstm_scan(wx, r, b)[0]


def _dtensor_scan(wx, r, b, state, out_state, n_cta):
    """:func:`slstm_scan` on DTensors, on each device's shards
    (``_shard.local_call``: batch and heads may stay sharded); the final
    state is copied into ``out_state`` at the DTensor level, which
    redistributes it to the state's placements."""
    ins = tuple(state) if state is not None else ()

    def local(wx, r, b, *st):
        hs, final = slstm_scan(wx, r, b, st or None, n_cta=n_cta)
        return (hs, *final)

    hs, *final = _shard.local_call(
        local, (wx, r, b, *ins), ((0, 3), (None, 1), (None, 1),
                                  *((0, 1),) * len(ins)),
        ((0, 2),) + ((0, 1),) * 4)
    if out_state is not None:
        for dst, src in zip(out_state, final):
            dst.copy_(src)
        final = out_state
    return hs, tuple(final)
