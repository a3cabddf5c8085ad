"""Plain PyTorch versions of the halo-partitioned conv block (paper
section 3.2): the parity oracles of the conv kernel, and the path that CPU
tensors take.

Layouts are the JAX package's: activations NHWC, weights HWIO
``[3, 3, Cin, Cout]``.  ``conv_block_ref`` is the whole-image oracle: the
image is zero-padded once by the block's halo radius (one ring per 3x3
layer) and the convolutions run VALID, so intermediate halo values carry
through the block and the result does not depend on the tiling.
``halo_conv_block_tiles_ref`` is the kernel's own function on padded
tiles: f32 math through every layer, output in the input dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def conv2d_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, Cin], w [kh, kw, Cin, Cout]; stride 1, VALID padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _leaky(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def conv_block_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   leaky_slope: float = 0.1) -> torch.Tensor:
    """A YoloV2-style block: n consecutive 3x3 convs + leaky ReLU, each in
    the input dtype, after one zero pad of radius n."""
    r = len(weights)
    x = F.pad(x, (0, 0, r, r, r, r))
    for w in weights:
        x = _leaky(conv2d_valid(x, w), leaky_slope)
    return x


def halo_conv_block_tiles_ref(tiles: torch.Tensor,
                              weights: Sequence[torch.Tensor], *,
                              leaky: float = 0.1) -> torch.Tensor:
    """tiles [T, th + 2n, tw + 2n, Cin] -> [T, th, tw, Cout]: the n VALID
    convs of each padded tile in f32, cast back to the tiles' dtype."""
    x = tiles.float()
    for w in weights:
        x = _leaky(conv2d_valid(x, w.float()), leaky)
    return x.to(tiles.dtype)


def maxpool2x2_ref(x: torch.Tensor) -> torch.Tensor:
    """x [N, H, W, C] -> [N, H // 2, W // 2, C]: a VALID 2x2 max, stride 2
    (a trailing odd row or column is dropped)."""
    n, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
