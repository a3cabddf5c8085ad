"""Wrapper of the halo conv kernel (``csrc/halo_conv2d.cu``) and the whole
halo-partitioned block: overlapping-tile gather (the border exchange), the
per-tile conv kernel, reassembly.

``halo_conv_block(x, weights, tiles=(2, 2))`` equals ``conv_block_ref`` for
any tiling; the tile count is the paper's 2-core / 4-core configuration.
CPU tensors take the plain version; CUDA tensors launch the kernel (one
launch per 3x3 layer) or raise.  ``halo_conv_block_tiles.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .ref import conv_block_ref, halo_conv_block_tiles_ref

NAME = "halo_conv2d"


def _launcher():
    fn = _build.load(NAME).halo_conv3x3_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + \
        [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    chans = [cin] + [w.shape[-1] for w in weights]
    _build.check_inputs(
        NAME, (tiles, *weights),
        shapes_ok=n_layers >= 1 and all(
            w.shape == (3, 3, chans[i], chans[i + 1])
            for i, w in enumerate(weights)))
    code = _build.DTYPE_CODES[tiles.dtype]
    x, x_code = tiles, code
    launch = _launcher()
    for i, w in enumerate(weights):
        last = i == n_layers - 1
        hin, win = x.shape[1], x.shape[2]
        y = torch.empty((t, hin - 2, win - 2, chans[i + 1]),
                        dtype=tiles.dtype if last else torch.float32,
                        device=tiles.device)
        y_code = code if last else _build.DTYPE_CODES[torch.float32]
        with torch.cuda.device(tiles.device):
            err = launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), t, hin,
                         win, chans[i], chans[i + 1], float(leaky), x_code,
                         code, y_code,
                         torch.cuda.current_stream(tiles.device).cuda_stream)
        _build.check(err, NAME)
        halo_conv_block_tiles.launches += 1
        x, x_code = y, y_code
    return x


halo_conv_block_tiles.launches = 0


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
