"""Wrappers of the flash attention kernel (``csrc/flash_attention.cu``)
and of its backward (``csrc/flash_attention_bwd.cu``).

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise.  ``flash_attention.launches`` counts forward launches,
``flash_attention_bwd.launches`` backward calls (three kernels each).
Where grad mode is on and an input requires grad, ``flash_attention``
runs through :class:`FlashAttentionFn`, whose backward is the backward
kernel (the plain backward for CPU tensors); otherwise nothing is saved.

The kernel folds each GQA group into the rows of one CTA: KV head ``kvh``
has M = G x T rows, row r being query head ``kvh * G + r // T`` at token
``r % T``, and a CTA owns ``plan.rows`` of them.  Where the prompt is long,
the CTA's warps form two key groups over the same rows, which walk
alternate K tiles and merge at the end.  :func:`plan_flash` is that cut,
with the kernel's width class, K tile and shared memory; the tile-skip rule
and the CTA's walk over K tiles are stated here as the kernel runs them
(:func:`tile_rule`, :func:`visit_list`).  The kernels' shared-memory limit
is set once per device.

The backward's tiles, grids, shared memory and scratch are
:func:`plan_flash_bwd`'s: by dtype and width class from the kernel's
tables, with dK/dV's G x T rows cut into chunks where the KV heads alone
give too few CTAs.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import torch

from .. import _build, _shard
from .ref import flash_attention_bwd_ref, flash_attention_ref

NAME = "flash_attention"
SM_COUNT = 132              # H100 SXM
SMEM_LIMIT = 232448         # kMaxSmem: dynamic shared memory a CTA (227 KB)
MAX_ROWS = 128              # kMaxRows: 8 warps of 16 rows
MAX_THREADS = 2 * MAX_ROWS  # rows x 2 threads x key groups
SPLIT_CLASS = 64            # the width class built with two key groups
MAX_HEAD_DIM = 256          # kMaxHeadDim
D_CLASSES = (64, 128, 256)  # kDMax: D is padded up to a class's instance
# kBK and kStages: keys a K tile and stages of the ring, by class
TILE_KEYS = {torch.float32: (32, 32, 16), torch.bfloat16: (64, 64, 32)}
STAGES = {torch.float32: (2, 2, 2), torch.bfloat16: (3, 2, 2)}
# f32 split passes (A piece, B piece), small products first (pass_a/pass_b)
PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))

# flash_attention_launch: q, k, v, q_pos, k_pos, out; B, T, S, H, KV, D,
# causal, window, dtype, rows, ks, smem; stream
ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
# The backward (flash_attention_bwd.cu), by dtype and width class: (a) the
# statistics' (query rows a CTA, half of them where the visit list would not
# fit, keys a K tile) (kStatsRows, kStatsKeys);
# (b) dK/dV's (warps, warps sharing 16 keys, query rows a step) (kKeyWarps,
# kKeyParts, kKeyStep); (c) dQ's (warps, warps sharing 16 rows, keys a K
# tile) (kRowWarps, kRowParts, kRowKeys).
BWD_STAGES = 2              # kStages: the cp.async ring of (b) and (c)
BWD_STATS = {torch.float32: ((128, 32), (128, 32), (128, 16)),
             torch.bfloat16: ((128, 64), (128, 32), (64, 16))}
BWD_KEYS = {torch.float32: ((8, 1, 32), (8, 2, 16), (8, 4, 16)),
            torch.bfloat16: ((8, 1, 64), (8, 2, 32), (8, 2, 32))}
BWD_ROWS = {torch.float32: ((8, 1, 32), (8, 2, 16), (8, 4, 16)),
            torch.bfloat16: ((8, 1, 64), (8, 1, 64), (8, 1, 32))}
# dK/dV's query rows are cut into at most this many chunks, until the grid
# holds about BWD_SPLIT_WAVES CTAs an SM
MAX_SPLIT = 8
BWD_SPLIT_WAVES = 3
# flash_attention_bwd_launch: q, k, v, q_pos, k_pos, out, d_out, dq, dk, dv,
# lse, delta, planes, partials; B, T, S, H, KV, D, causal, window, dtype,
# stats rows, n_split, chunk, smem x 3; stream
BWD_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 15 + \
    [ctypes.c_void_p]

_lib_fns = None
_set_up: set[int] = set()                  # devices whose limits are set


class FlashPlan(NamedTuple):
    rows: int                       # rows a CTA, 16 a warp of a key group
    key_groups: int                 # 1, or 2 walking alternate K tiles
    threads: int                    # 2 x rows x key_groups
    d_class: int                    # D padded up to the kernel's width class
    tile_keys: int                  # keys a K tile (BK)
    stages: int                     # stages of the cp.async ring
    n_key_tiles: int                # ceil(S / BK)
    n_row_tiles: int                # ceil(M / rows)
    grid: tuple[int, int, int]      # (KV x B, row tiles, 1)
    smem_bytes: int                 # dynamic shared memory a CTA


def smem_bytes(dtype: torch.dtype, d_class: int, rows: int,
               n_key_tiles: int, key_groups: int) -> int:
    """Q planes, the ring of K/V tiles with their positions (which the key
    groups' merge reuses), in f32 the split tiles, the tile flags and the
    visit list (``layout`` in the kernel)."""
    c = D_CLASSES.index(d_class)
    f32 = dtype == torch.float32
    bk, st = TILE_KEYS[dtype][c], STAGES[dtype][c]
    rs = (d_class + 8) * 2                      # bytes a bf16 row
    raw = d_class * 4 if f32 else rs            # bytes a staged row
    planes = 3 if f32 else 1
    ring = st * key_groups * (2 * bk * raw + bk * 4)
    merge = 2 * rows * (d_class // 2 + 4) * 4 if key_groups > 1 else 0
    r16 = lambda x: -(-x // 16) * 16            # noqa: E731
    return (planes * rows * rs + max(ring, merge)
            + key_groups * (6 * bk * rs if f32 else 0) + r16(n_key_tiles)
            + r16(4 * n_key_tiles) + 16)


@functools.lru_cache(maxsize=256)
def plan_flash(b: int, t: int, s: int, h: int, kv: int, d: int,
               dtype: torch.dtype) -> FlashPlan:
    """Two key groups at the 64 width class where the prompt spans two K
    tiles or more and the two-group CTAs (64 rows, 256 threads, one an SM
    by registers) still fit in one wave over the card's SMs; one group
    otherwise.  Two groups halve the longest CTA's walk and double the
    threads that copy, which pays on small grids; on larger ones a second
    CTA an SM pays more (PERF.md has the measurements).  128 rows a CTA
    where that still gives a wave of CTAs and there is one key group, else
    64, never fewer (a CTA's threads also copy its K/V tiles); halved while
    the shared memory does not fit.  The width class, K tile and stages
    follow from D and the dtype."""
    if dtype not in TILE_KEYS:
        raise ValueError(f"{NAME}: dtype {dtype} not supported")
    if min(b, t, s, h, kv, d) < 1 or h % kv:
        raise ValueError(f"{NAME}: no plan for B={b} T={t} S={s} H={h} "
                         f"KV={kv} D={d}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{NAME}: head dim {d} outside 1..{MAX_HEAD_DIM}")
    m = h // kv * t
    c = next(i for i, dc in enumerate(D_CLASSES) if d <= dc)
    bk = TILE_KEYS[dtype][c]
    n_kt = -(-s // bk)
    # the threads (two a row) copy rows in 16-byte units of 4 columns of Q:
    # at the 256 class a row is 64 of them, so rows go by 32
    step = max(16, D_CLASSES[c] // 8)
    split = D_CLASSES[c] == SPLIT_CLASS and n_kt >= 2 and \
        math.ceil(m / 64) * kv * b <= SM_COUNT
    for ks in (2, 1) if split else (1,):
        rows = MAX_ROWS if ks == 1 and \
            math.ceil(m / MAX_ROWS) * kv * b >= SM_COUNT else 64
        while rows > step and smem_bytes(dtype, D_CLASSES[c], rows, n_kt,
                                         ks) > SMEM_LIMIT:
            rows = max(step, rows // 2 // step * step)
        smem = smem_bytes(dtype, D_CLASSES[c], rows, n_kt, ks)
        if smem <= SMEM_LIMIT:
            break
    if smem > SMEM_LIMIT:
        raise ValueError(f"{NAME}: S={s} needs {smem} bytes of shared "
                         f"memory a CTA, over {SMEM_LIMIT}")
    n_rt = -(-m // rows)
    if n_rt > 65535:
        raise ValueError(f"{NAME}: {n_rt} row tiles of {rows}, over 65535")
    return FlashPlan(rows, ks, 2 * rows * ks, D_CLASSES[c], bk,
                     STAGES[dtype][c], n_kt, n_rt, (kv * b, n_rt, 1), smem)


def query_rows(plan: FlashPlan, t: int, group: int, by: int, kvh: int):
    """(query head, token) of each row that CTA (kvh + KV x batch, by)
    computes: row tiles run latest first, rows past M = group x t are
    idle."""
    m0 = (plan.n_row_tiles - 1 - by) * plan.rows
    return [(kvh * group + r // t, r % t)
            for r in range(m0, min(m0 + plan.rows, group * t))]


def tile_rule(qp_min: int, qp_max: int, kp_min: int, kp_max: int,
              whole: bool, causal: bool, window: int) -> int:
    """0: no pair of the K tile is valid for the CTA's rows (skipped, never
    loaded); 1: masked pair by pair; 2: every pair valid.  ``whole``: no key
    of the tile lies past S.  The kernel's ``tile_rule``."""
    if not causal:
        return 2 if whole else 1
    if kp_min > qp_max:
        return 0
    if window > 0 and kp_max <= qp_min - window:
        return 0
    every = kp_max <= qp_min and (window <= 0 or kp_min > qp_max - window)
    return 2 if whole and every else 1


def visit_list(plan: FlashPlan, q_pos: Sequence[int], k_pos: Sequence[int],
               group: int, by: int, causal: bool,
               window: int) -> list[tuple[int, bool]]:
    """The K tiles that the CTAs of row tile ``by`` visit, in order, each
    with whether it is taken unmasked: the kernel's prologue.  Key group g
    takes visits g, g + key_groups, ..."""
    t, s, bk = len(q_pos), len(k_pos), plan.tile_keys
    m0 = (plan.n_row_tiles - 1 - by) * plan.rows
    qps = [q_pos[r % t] for r in range(m0, min(m0 + plan.rows, group * t))]
    out = []
    for j in range(plan.n_key_tiles):
        kps = k_pos[j * bk:(j + 1) * bk]
        f = tile_rule(min(qps), max(qps), min(kps), max(kps),
                      (j + 1) * bk <= s, causal, window)
        if f:
            out.append((j, f == 2))
    return out


def _lib():
    global _lib_fns
    if _lib_fns is None:
        lib = _build.load(NAME)
        launch = lib.flash_attention_launch
        launch.argtypes = ARGTYPES
        launch.restype = ctypes.c_int
        bwd = lib.flash_attention_bwd_launch
        bwd.argtypes = BWD_ARGTYPES
        bwd.restype = ctypes.c_int
        setups = (lib.flash_attention_setup, lib.flash_attention_bwd_setup)
        for setup in setups:
            setup.argtypes = []
            setup.restype = ctypes.c_int
        _lib_fns = (launch, setups, bwd)
    return _lib_fns


def _set_limits(device: torch.device) -> None:
    """The kernels' shared-memory limit, once per device and outside
    CUDA-graph capture (a first call before capture sets it)."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx in _set_up:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{NAME}: call once on cuda:{idx} outside "
                           "CUDA-graph capture before capturing")
    with torch.cuda.device(idx):
        for setup in _lib()[1]:
            _build.check(setup(), NAME)
    _set_up.add(idx)


def n_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs that attend, for T queries at the last T of S
    key positions 0..S-1 (a prompt or a training sequence over itself):
    all T x S unmasked."""
    if not causal:
        return t * s
    lo = s - t + 1                  # keys the first query sees, unwindowed
    w = window if window > 0 else s
    top = min(s, w)
    under = (top * (top + 1) - (lo - 1) * lo) // 2 if top >= lo else 0
    return under + max(0, s - max(lo - 1, w)) * w


# (batch dim, head dim) of q, k, v, the positions and the output, for the
# kernels' rule under DTensor (``_shard.local_call``)
_QKV_DIMS = ((0, 2), (0, 2), (0, 2), None, None)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: int) -> torch.Tensor:
    """The plain version for CPU tensors; on meta tensors no launch (the
    dry run: an empty output, the work reported); else one launch of the
    kernel."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                   window=window)
    b, t, h, d = q.shape
    _, s, kv, _ = k.shape
    if q.device.type == "meta":
        pairs = b * n_pairs(t, s, causal, window)
        _shard.meta_launch(NAME, 4.0 * h * d * pairs,
                           _shard.nbytes(q, k, v, q_pos, k_pos, q))
        return torch.empty_like(q)
    _build.check_inputs(
        NAME, (q, k, v), (q_pos, k_pos),
        shapes_ok=(k.shape == (b, s, kv, d) and v.shape == k.shape
                   and q_pos.shape == (t,) and k_pos.shape == (s,)
                   and h % kv == 0),
        head_dim=d, max_head_dim=MAX_HEAD_DIM)
    plan = plan_flash(b, t, s, h, kv, d, q.dtype)
    _set_limits(q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), b, t, s, h, kv, d,
            int(bool(causal)), int(window), _build.DTYPE_CODES[q.dtype],
            plan.rows, plan.key_groups, plan.smem_bytes,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, NAME)
    flash_attention.launches += 1
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its backward kernel as the gradient: the
    forward saves q, k, v, the positions and the output; the backward
    launches :func:`flash_attention_bwd` (its plain version for CPU
    tensors).  Positions, mask and window get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal: bool, window: int):
        out = _forward(q, k, v, q_pos, k_pos, causal, window)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, q_pos, k_pos, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, q_pos, k_pos, out,
                                         d_out.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, S, KV, D]
    v: torch.Tensor,
    q_pos: torch.Tensor,        # [T] int32 absolute positions
    k_pos: torch.Tensor,        # [S] int32
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Full-sequence GQA attention in the model's layout -> [B, T, H, D];
    differentiable through :class:`FlashAttentionFn` where an input
    requires grad.  DTensor inputs run on each device's shards
    (``_shard.local_call``: batch and whole GQA groups may stay sharded)."""
    if _shard.is_dtensor(q) or _shard.is_dtensor(k):
        return _shard.local_call(
            functools.partial(flash_attention, causal=causal, window=window),
            (q, k, v, q_pos, k_pos), _QKV_DIMS, ((0, 2),))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_pos, k_pos, bool(causal),
                                      int(window))
    return _forward(q, k, v, q_pos, k_pos, causal, window)


flash_attention.launches = 0


class FlashBwdPlan(NamedTuple):
    d_class: int                    # D padded up to the kernel's width class
    planes: int                     # bf16 planes an operand: 3 in f32, 1
    stats_rows: int                 # (a): query rows a CTA
    stats_keys: int                 # (a): keys a K tile
    keys: int                       # (b): keys a CTA, 16 a group of warps
    key_parts: int                  # (b): warps sharing 16 keys
    step_rows: int                  # (b): query rows a step of its walk
    n_split: int                    # (b): chunks of the G x T query rows
    chunk: int                      # (b): rows a chunk, a multiple of step
    rows: int                       # (c): query rows a CTA
    row_parts: int                  # (c): warps sharing 16 rows
    tile_keys: int                  # (c): keys a K tile
    stats_grid: tuple[int, int, int]  # (KV x B, ceil(M / stats_rows), 1)
    key_grid: tuple[int, int, int]    # (KV x B, key tiles x n_split, 1)
    row_grid: tuple[int, int, int]    # (KV x B, ceil(M / rows), 1)
    threads: tuple[int, int, int]     # (a), (b), (c)
    smem_bytes: tuple[int, int, int]  # (a), (b), (c)
    plane_values: int               # bf16 values of the planes scratch
    partial_values: int             # f32 values of the dK/dV partials


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def _list_bytes(n: int) -> int:
    """A visit list of n tiles: flags, the list, its length."""
    return _r16(n) + _r16(4 * n) + 16


def bwd_smem_bytes(dtype: torch.dtype, d_class: int, n_key_tiles: int,
                   n_steps: int, n_row_key_tiles: int,
                   stats_rows: int | None = None) -> tuple[int, int, int]:
    """Dynamic shared memory of the stats, dK/dV and dQ kernels (the
    kernel's ``*_fixed`` and ``list_bytes``): bf16 rows of (d_class + 8)
    values in ``planes`` planes; (a) Q planes, one K tile's planes, its
    positions; (b) K and V planes, their positions, the ring of 2 stages of
    Q and dO planes with positions, lse and delta, the parts' S and dP;
    (c) Q and dO planes, lse and delta, the ring of K and V planes with
    positions, the parts' S and dP; each with its visit list (n_key_tiles
    K tiles of (a), n_steps row steps of (b), n_row_key_tiles of (c));
    (a) at the table's rows unless ``stats_rows`` is given."""
    c = D_CLASSES.index(d_class)
    pl = 3 if dtype == torch.float32 else 1
    rs = (d_class + 8) * 2
    s_rows, s_keys = BWD_STATS[dtype][c]
    s_rows = stats_rows or s_rows
    k_warps, k_parts, bm = BWD_KEYS[dtype][c]
    q_warps, q_parts, bn = BWD_ROWS[dtype][c]
    keys, rows = 16 * k_warps // k_parts, 16 * q_warps // q_parts
    stats = pl * (s_rows + s_keys) * rs + _r16(4 * s_keys)
    dkdv = (2 * pl * keys * rs + _r16(4 * keys)
            + BWD_STAGES * (2 * pl * bm * rs + 12 * bm)
            + (k_warps * 2 * 16 * bm * 4 if k_parts > 1 else 0))
    dq = (2 * pl * rows * rs + 8 * rows
          + BWD_STAGES * (2 * pl * bn * rs + _r16(4 * bn))
          + (q_warps * 2 * 16 * bn * 4 if q_parts > 1 else 0))
    return (stats + _list_bytes(n_key_tiles), dkdv + _list_bytes(n_steps),
            dq + _list_bytes(n_row_key_tiles))


@functools.lru_cache(maxsize=256)
def plan_flash_bwd(b: int, t: int, s: int, h: int, kv: int, d: int,
                   dtype: torch.dtype) -> FlashBwdPlan:
    """The backward's tiles by dtype and width class (the tables
    ``BWD_STATS``, ``BWD_KEYS``, ``BWD_ROWS``, the kernel's; the
    statistics at half their rows where S's visit list would not fit
    otherwise), and the cut of dK/dV's G x T query rows into ``n_split``
    chunks: as many as bring the grid to ``BWD_SPLIT_WAVES`` CTAs an SM, at
    most ``MAX_SPLIT``, more only where a chunk's visit list would not fit
    in shared memory."""
    if dtype not in BWD_STATS:
        raise ValueError(f"{NAME}: dtype {dtype} not supported")
    if min(b, t, s, h, kv, d) < 1 or h % kv:
        raise ValueError(f"{NAME}: no backward plan for B={b} T={t} S={s} "
                         f"H={h} KV={kv} D={d}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{NAME}: head dim {d} outside 1..{MAX_HEAD_DIM}")
    c = next(i for i, dc in enumerate(D_CLASSES) if d <= dc)
    d_class, dp = D_CLASSES[c], -(-d // 16) * 16
    pl = 3 if dtype == torch.float32 else 1
    s_rows, s_keys = BWD_STATS[dtype][c]
    k_warps, k_parts, bm = BWD_KEYS[dtype][c]
    q_warps, q_parts, bn = BWD_ROWS[dtype][c]
    keys, rows = 16 * k_warps // k_parts, 16 * q_warps // q_parts
    m = h // kv * t
    n_keys = -(-s // keys)
    n_split = max(1, min(MAX_SPLIT, -(-BWD_SPLIT_WAVES * SM_COUNT
                                      // (kv * b * n_keys))))
    if bwd_smem_bytes(dtype, d_class, -(-s // s_keys), 1,
                      1)[0] > SMEM_LIMIT:
        s_rows //= 2
    while True:
        chunk = -(-m // (n_split * bm)) * bm    # ceil(m / n_split) to bm
        n_split = -(-m // chunk)
        smem = bwd_smem_bytes(dtype, d_class, -(-s // s_keys), chunk // bm,
                              -(-s // bn), s_rows)
        if smem[1] <= SMEM_LIMIT or chunk == bm:
            break
        n_split += 1
    if max(smem) > SMEM_LIMIT:
        raise ValueError(f"{NAME}: S={s} needs {max(smem)} bytes of shared "
                         f"memory a CTA in the backward, over {SMEM_LIMIT}")
    grids = ((kv * b, -(-m // s_rows), 1), (kv * b, n_keys * n_split, 1),
             (kv * b, -(-m // rows), 1))
    if max(g[1] for g in grids) > 65535:
        raise ValueError(f"{NAME}: backward grid {grids}, over 65535")
    return FlashBwdPlan(
        d_class, pl, s_rows, s_keys, keys, k_parts, bm, n_split, chunk,
        rows, q_parts, bn, *grids, (2 * s_rows, 32 * k_warps, 32 * q_warps),
        smem, 2 * b * kv * pl * (m + s) * dp,
        2 * n_split * b * s * kv * d if n_split > 1 else 0)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, k_pos: torch.Tensor,
    out: torch.Tensor,          # [B, T, H, D] the forward's output
    d_out: torch.Tensor,        # [B, T, H, D]
    *,
    causal: bool = True,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention`: the plain version for CPU
    tensors; on meta tensors no launch (empty gradients, the work
    reported); else the three launches of the backward kernel (row
    statistics, dK/dV, dQ) into fresh outputs of the inputs' dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, q_pos, k_pos, out, d_out,
                                       causal=causal, window=window)
    b, t, h, d = q.shape
    _, s, kv, _ = k.shape
    if q.device.type == "meta":
        pairs = b * n_pairs(t, s, causal, window)
        _shard.meta_launch("flash_attention_bwd", 10.0 * h * d * pairs,
                           _shard.nbytes(q, k, v, q_pos, k_pos, out, d_out,
                                         q, k, v))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.check_inputs(
        NAME, (q, k, v, out, d_out), (q_pos, k_pos),
        shapes_ok=(k.shape == (b, s, kv, d) and v.shape == k.shape
                   and out.shape == q.shape and d_out.shape == q.shape
                   and q_pos.shape == (t,) and k_pos.shape == (s,)
                   and h % kv == 0),
        head_dim=d, max_head_dim=MAX_HEAD_DIM)
    plan = plan_flash_bwd(b, t, s, h, kv, d, q.dtype)
    _set_limits(q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    planes = torch.empty(plan.plane_values, dtype=torch.bfloat16,
                         device=q.device)
    partials = torch.empty(plan.partial_values, dtype=torch.float32,
                           device=q.device) if plan.partial_values else None
    with torch.cuda.device(q.device):
        err = _lib()[2](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), d_out.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), planes.data_ptr(),
            None if partials is None else partials.data_ptr(), b, t, s, h,
            kv, d, int(bool(causal)), int(window),
            _build.DTYPE_CODES[q.dtype], plan.stats_rows, plan.n_split,
            plan.chunk,
            *plan.smem_bytes,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, NAME)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def mha_attention(
    q: torch.Tensor,            # [B, T, H, D]
    k: torch.Tensor,            # [B, T, H, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Self-attention of a T-token sequence in the model's layout -> [B, T,
    H, D]: :func:`flash_attention` at positions 0..T-1 (unmasked with
    ``causal=False``, where ``window`` is ignored), differentiable as it is.
    A test-only parity shim of the JAX adapter of the same name; no path of
    the port calls it.  The kernel takes the model's layout and any T, so
    nothing is transposed and no length falls back to the plain version,
    and the JAX adapter's Pallas switches (``use_pallas``, ``interpret``)
    are not taken: CUDA tensors always launch the kernel, CPU tensors take
    the plain version.  The oracle is :func:`.ref.attention_ref`."""
    p = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
    return flash_attention(q, k, v, p, p, causal=causal, window=window)
