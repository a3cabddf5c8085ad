"""Wrapper of the halo conv kernel (``csrc/halo_conv2d.cu``) and the whole
halo-partitioned block: overlapping-tile gather (the border exchange), the
per-tile conv kernel, reassembly.

``halo_conv_block(x, weights, tiles=(2, 2))`` equals ``conv_block_ref`` for
any tiling; the tile count is the paper's 2-core / 4-core configuration.
CPU tensors take the plain version; CUDA tensors launch the kernel (one
launch per 3x3 layer) or raise, also where they require grad (the kernel
has no backward).  The kernel multiplies bf16 planes on the
tensor cores: an f32 operand is split into three exact bf16 pieces, by the
split kernel of the same source for the first layer's input and the
weights, and by the previous layer's epilogue between layers
(``plan_block`` gives each layer's planes, passes and CTA tile).
``halo_conv_block_tiles.launches`` counts conv kernel launches,
``halo_conv_block_tiles.split_launches`` split kernel launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .ref import conv_block_ref, halo_conv_block_tiles_ref

NAME = "halo_conv2d"

BK = 32                     # K slice: 32 input channels of one tap
N_SMS = 132                 # H100 SXM
# CTA tiles (M x N) by the code the kernel takes (csrc kTileM, kTileN),
# largest first.
TILES = ((64, 64), (32, 64))
MIN_CTAS = 2 * N_SMS        # a layer's grid should give every SM two CTAs
# Split passes (A piece, B piece) of one K slice, in the kernel's order
# (csrc pass_a, pass_b), by (A planes, B planes): a bf16 operand is one
# plane, an f32 operand three (hi, mid, lo).
PASSES = {(1, 1): ((0, 0),),
          (3, 1): ((0, 0), (1, 0), (2, 0)),
          (3, 3): ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))}


@dataclass(frozen=True)
class LayerPlan:
    """One layer's launch.  ``k_walk`` is what fixes the order in which
    every output element sums its terms (K slice width, channel chunks per
    tap, passes); it must not depend on the tiling."""
    tile: int                 # index into TILES
    grid: tuple[int, int]
    a_planes: int
    b_planes: int
    k_walk: tuple


def plan_layer(m: int, cin: int, cout: int, a_planes: int,
               b_planes: int) -> LayerPlan:
    """The largest CTA tile whose grid still gives every SM two CTAs (else
    the smallest), for an M x Cout output with K = 9 x cin."""
    for tile, (bm, bn) in enumerate(TILES):
        grid = (-(-m // bm), -(-cout // bn))
        if grid[0] * grid[1] >= MIN_CTAS:
            break
    return LayerPlan(tile, grid, a_planes, b_planes,
                     (BK, -(-cin // BK), PASSES[(a_planes, b_planes)]))


def plan_block(n_tiles: int, ph: int, pw: int, chans: Sequence[int],
               dtype: torch.dtype) -> list[LayerPlan]:
    """Every layer's plan: f32 tiles run three planes against three (f32
    weights); bf16 tiles one plane in the first layer and the three planes
    of the f32 intermediate after it, against one (bf16 weights)."""
    f32 = dtype == torch.float32
    plans = []
    for i in range(len(chans) - 1):
        ph, pw = ph - 2, pw - 2
        plans.append(plan_layer(n_tiles * ph * pw, chans[i], chans[i + 1],
                                3 if f32 or i else 1, 3 if f32 else 1))
    return plans


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def _fns():
    lib = _build.load(NAME)
    conv = lib.halo_conv3x3_launch
    conv.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    conv.restype = ctypes.c_int
    split = lib.halo_split_launch
    split.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_longlong] + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    split.restype = ctypes.c_int
    return conv, split


def _as_planes(src: torch.Tensor, planes: int, split, stream: int):
    """src [rows, cols] -> (bf16 planes [planes, rows, cols_pad], cols_pad,
    plane stride): an aligned bf16 source with cols a multiple of 8 as it
    is, else through the split kernel (three pieces of f32, or a zero-padded
    bf16 copy)."""
    rows, cols = src.shape
    if planes == 1 and cols % 8 == 0 and src.data_ptr() % 16 == 0:
        return src, cols, 0
    pad = _pad8(cols)
    dst = torch.empty((planes, rows, pad), dtype=torch.bfloat16,
                      device=src.device)
    _build.check(split(src.data_ptr(), _build.DTYPE_CODES[src.dtype],
                       dst.data_ptr(), rows, cols, pad, planes, stream),
                 NAME)
    halo_conv_block_tiles.split_launches += 1
    return dst, pad, rows * pad


def _extract_tiles(xp: torch.Tensor, n_th: int, n_tw: int, th: int, tw: int,
                   r: int) -> torch.Tensor:
    """xp [N, H + 2r, W + 2r, C] -> [N * n_th * n_tw, th + 2r, tw + 2r, C]."""
    n, c = xp.shape[0], xp.shape[-1]
    out = [xp[:, i * th:i * th + th + 2 * r, j * tw:j * tw + tw + 2 * r, :]
           for i in range(n_th) for j in range(n_tw)]
    return torch.stack(out, dim=1).reshape(n * n_th * n_tw, th + 2 * r,
                                           tw + 2 * r, c)


def halo_conv_block_tiles(
    tiles: torch.Tensor,                  # [T, th + 2n, tw + 2n, Cin]
    weights: Sequence[torch.Tensor],      # n x [3, 3, C, C']
    *,
    tile_h: int,
    tile_w: int,
    leaky: float = 0.1,
) -> torch.Tensor:
    """n fused VALID 3x3 convs + leaky-ReLU per padded tile ->
    [T, tile_h, tile_w, Cout] in the tiles' dtype (f32 accumulation and f32
    intermediates)."""
    n_layers = len(weights)
    t, ph, pw, cin = tiles.shape
    if ph != tile_h + 2 * n_layers or pw != tile_w + 2 * n_layers:
        raise ValueError(f"tiles {tuple(tiles.shape)} are not tiles of "
                         f"{tile_h}x{tile_w} padded by {n_layers}")
    if tiles.device.type == "cpu":
        return halo_conv_block_tiles_ref(tiles, weights, leaky=leaky)
    _build.refuse_grad(NAME, tiles, *weights)
    chans = [cin] + [w.shape[-1] for w in weights]
    _build.check_inputs(
        NAME, (tiles, *weights),
        shapes_ok=n_layers >= 1 and all(
            w.shape == (3, 3, chans[i], chans[i + 1])
            for i, w in enumerate(weights)))
    plans = plan_block(t, ph, pw, chans, tiles.dtype)
    conv, split = _fns()
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        a, a_cs, a_ps = _as_planes(tiles.reshape(-1, cin),
                                   plans[0].a_planes, split, stream)
        hin, win = ph, pw
        for i, (w, plan) in enumerate(zip(weights, plans)):
            cout = chans[i + 1]
            b, b_cs, b_ps = _as_planes(w.reshape(9 * chans[i], cout),
                                       plan.b_planes, split, stream)
            hin, win = hin - 2, win - 2
            m = t * hin * win
            if i == n_layers - 1:
                y = torch.empty((t, hin, win, cout), dtype=tiles.dtype,
                                device=tiles.device)
                y_mode, y_cs, y_ps = _build.DTYPE_CODES[tiles.dtype], cout, 0
            else:
                y_cs = _pad8(cout)
                y = torch.empty((3, m, y_cs), dtype=torch.bfloat16,
                                device=tiles.device)
                y_mode, y_ps = 2, m * y_cs
            _build.check(conv(a.data_ptr(), a_ps, plan.a_planes, a_cs,
                              b.data_ptr(), b_ps, plan.b_planes, b_cs,
                              y.data_ptr(), y_mode, y_ps, y_cs, t, hin + 2,
                              win + 2, chans[i], cout, float(leaky),
                              plan.tile, stream), NAME)
            halo_conv_block_tiles.launches += 1
            a, a_cs, a_ps = y, y_cs, y_ps
    return y


halo_conv_block_tiles.launches = 0
halo_conv_block_tiles.split_launches = 0


def halo_conv_block(
    x: torch.Tensor,                      # [N, H, W, Cin]
    weights: Sequence[torch.Tensor],
    *,
    tiles: tuple[int, int] = (2, 2),
    leaky: float = 0.1,
) -> torch.Tensor:
    """The whole block on an NHWC image, partitioned into ``tiles``
    (rows, columns) of halo-padded tiles -> [N, H, W, Cout]."""
    n, h, w, _ = x.shape
    n_th, n_tw = tiles
    if h % n_th or w % n_tw:
        raise ValueError(f"tile counts {tiles} must divide H={h}, W={w}")
    th, tw = h // n_th, w // n_tw
    r = len(weights)
    xp = F.pad(x, (0, 0, r, r, r, r))
    tl = _extract_tiles(xp, n_th, n_tw, th, tw, r)
    yt = halo_conv_block_tiles(tl, weights, tile_h=th, tile_w=tw,
                               leaky=leaky)
    cout = yt.shape[-1]
    yt = yt.reshape(n, n_th, n_tw, th, tw, cout)
    return yt.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, cout)


def halo_conv_block_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                        leaky: float = 0.1) -> torch.Tensor:
    return conv_block_ref(x, list(weights), leaky)
