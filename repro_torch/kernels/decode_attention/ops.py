"""Wrapper of the decode attention kernel (``csrc/decode_attention.cu``).

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  ``decode_attention.launches`` counts kernel launches: one per call,
the cross-chunk combine included.  The current position is a host int,
passed by value, or a 0-d int32 tensor on the card, whose address the
kernel gets and which it reads there: a launch captured in a CUDA graph
then serves every position written into that tensor.  The kernel has no
backward: on inputs off the CPU that require grad (grad mode on) the
wrapper raises.

The kernel cuts the cache's S slots into ``n_split`` chunks, one CTA each,
and its last CTA per (batch, KV head) merges their partials from an f32
workspace.  :func:`plan_split` is that cut; the CTAs meet on int32
counters that the kernel leaves at 0, kept here once per device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _build, _shard
from .ref import decode_attention_ref

NAME = "decode_attention"
MAX_CHUNK = 64          # slots a CTA takes at most (kMaxChunk in the kernel)
SM_COUNT = 132          # H100 SXM
MIN_COUNTERS = 1024

# decode_attention_launch: q, k, v, positions, out, ws, counters, pos_at
# (null: the position is pos); B, S, H, KV, D, chunk, n_split, pos, window,
# dtype; stream
ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]

_launch_fn = None
_counters: dict[int, torch.Tensor] = {}
_retired: list[torch.Tensor] = []   # outgrown counters a graph may still use


class SplitPlan(NamedTuple):
    chunk: int                      # slots per CTA (the last chunk ragged)
    n_split: int                    # CTAs per (batch, KV head)
    grid: tuple[int, int, int]      # (n_split, KV, B)
    workspace_shape: tuple          # f32 (B, KV, n_split, G, D + 2)


@functools.lru_cache(maxsize=256)
def plan_split(b: int, s: int, h: int, kv: int, d: int) -> SplitPlan:
    """Chunks of 32 slots while they fit on the card's SMs in one wave, else
    of ``MAX_CHUNK``; never longer than the cache."""
    chunk = 32 if b * kv * math.ceil(s / 32) <= SM_COUNT else MAX_CHUNK
    chunk = min(chunk, s)
    n_split = math.ceil(s / chunk)
    return SplitPlan(chunk, n_split, (n_split, kv, b),
                     (b, kv, n_split, h // kv, d + 2))


def _launcher():
    global _launch_fn
    if _launch_fn is None:
        fn = _build.load(NAME).decode_attention_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def _group_counters(device: torch.device, n: int) -> torch.Tensor:
    """Zeroed int32 counters, at least ``n``, for ``device``.  They are
    allocated outside CUDA-graph capture (a first call before capture does
    it) and never freed, since a captured graph keeps their address."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    t = _counters.get(idx)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{NAME}: call once outside CUDA-graph capture at batch x "
                f"KV heads >= {n} before capturing")
        if t is not None:
            _retired.append(t)
        t = torch.zeros(max(n, MIN_COUNTERS), dtype=torch.int32,
                        device=device)
        _counters[idx] = t
    return t


def decode_attention(
    q: torch.Tensor,            # [B, H, D]
    k_cache: torch.Tensor,      # [B, S, KV, D]
    v_cache: torch.Tensor,
    positions: torch.Tensor,    # [B, S] int32 (-1 = empty slot)
    pos,                        # current absolute position: host int or
    *,                          # 0-d int32 tensor on q's device
    window: int = 0,
) -> torch.Tensor:
    """One-token GQA attention over a position-tracked cache -> [B, H, D].
    DTensor inputs run on each device's shards (``_shard.local_call``:
    batch and whole GQA groups may stay sharded, the cache's slots are
    gathered); meta tensors launch nothing (the dry run: an empty output,
    the work reported for a cache filled up to ``pos``)."""
    if _shard.is_dtensor(q) or _shard.is_dtensor(k_cache):
        return _shard.local_call(
            functools.partial(decode_attention, pos=pos, window=window),
            (q, k_cache, v_cache, positions),
            ((0, 1), (0, 2), (0, 2), (0, None)), ((0, 1),))
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, positions, pos,
                                    window=window)
    _build.refuse_grad(NAME, q, k_cache, v_cache)
    b, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    if q.device.type == "meta":
        valid = b * min(pos + 1, s, window if window > 0 else s)
        _shard.meta_launch(NAME, 4.0 * h * d * valid, _shard.nbytes(
            q, positions, q) + 2 * valid * kv * d * k_cache.element_size())
        return torch.empty_like(q)
    at = isinstance(pos, torch.Tensor)
    _build.check_inputs(
        NAME, (q, k_cache, v_cache), (positions, pos) if at else (positions,),
        shapes_ok=(k_cache.shape == (b, s, kv, d)
                   and v_cache.shape == k_cache.shape
                   and positions.shape == (b, s) and h % kv == 0
                   and (not at or pos.numel() == 1)),
        head_dim=d)
    plan = plan_split(b, s, h, kv, d)
    out = torch.empty_like(q)
    ws = torch.empty(plan.workspace_shape, dtype=torch.float32,
                     device=q.device)
    counters = _group_counters(q.device, b * kv)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions.data_ptr(), out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), pos.data_ptr() if at else None, b, s, h,
            kv, d, plan.chunk, plan.n_split, 0 if at else int(pos),
            int(window), _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, NAME)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def cached_decode_attention(
    q: torch.Tensor,            # [B, 1, H, D] (model layout, one token)
    cache_k: torch.Tensor,      # [B, S, KV, D]
    cache_v: torch.Tensor,
    positions: torch.Tensor,    # [B, S] int32
    pos,                        # host int or 0-d tensor
    *,
    window: int = 0,
) -> torch.Tensor:
    """Decode attention against the model's cache layout -> [B, 1, H, D]:
    :func:`decode_attention` on the token's queries.  A test-only parity
    shim of the JAX adapter of the same name; no path of the port calls it.
    The kernel takes any S, so no cache length falls back to the plain
    version, and the JAX adapter's Pallas switches (``use_pallas``,
    ``interpret``) are not taken: CUDA tensors always launch the kernel,
    CPU tensors take the plain version.  The oracle is
    :func:`.ref.decode_attention_ref`."""
    return decode_attention(q[:, 0], cache_k, cache_v, positions, int(pos),
                            window=window)[:, None]
