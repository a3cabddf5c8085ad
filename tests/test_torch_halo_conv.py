"""The port's halo-partitioned conv block (plain route on the CPU) against
the JAX package's Pallas kernel (interpret mode) and its oracle.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance 1e-4: the reference's own (tests/test_kernels.py
test_halo_conv_matches_ref); tiling invariance at 1e-5 as there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.halo_conv2d.ops import _extract_tiles as jax_extract_tiles
from repro.kernels.halo_conv2d.ops import halo_conv_block as jax_halo_block
from repro.kernels.halo_conv2d.ref import conv_block_ref as jax_block_ref
from repro_torch.kernels.halo_conv2d import (conv_block_ref, halo_conv_block,
                                             halo_conv_block_ref,
                                             halo_conv_block_tiles,
                                             halo_conv_block_tiles_ref)
from repro_torch.kernels.halo_conv2d.ops import _extract_tiles

TOL = 1e-4


def _case(seed, n, hw, chans):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, *hw, chans[0])).astype(np.float32)
    ws = [(0.2 * rng.standard_normal((3, 3, chans[i], chans[i + 1])))
          .astype(np.float32) for i in range(len(chans) - 1)]
    return x, ws


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("hw,ch,n_layers,tiles", [
    ((16, 16), 8, 1, (2, 2)),
    ((16, 16), 8, 3, (2, 2)),
    ((8, 24), 4, 2, (2, 4)),
    ((32, 32), 16, 2, (4, 4)),
    ((16, 16), 8, 2, (1, 1)),
])
def test_halo_conv_block_matches_jax(hw, ch, n_layers, tiles):
    x, ws = _case(0, 2, hw, [ch] * (n_layers + 1))
    got = halo_conv_block(torch.from_numpy(x),
                          [torch.from_numpy(w) for w in ws], tiles=tiles)
    pallas = jax_halo_block(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                            tiles=tiles, interpret=True)
    oracle = jax_block_ref(jnp.asarray(x), list(map(jnp.asarray, ws)))
    assert got.shape == pallas.shape == (2, *hw, ch)
    assert _err(got, pallas) < TOL
    assert _err(got, oracle) < TOL
    ref = halo_conv_block_ref(torch.from_numpy(x),
                              [torch.from_numpy(w) for w in ws])
    assert _err(ref, oracle) < TOL


def test_halo_conv_channels_change_per_layer():
    """C -> C' -> C'': the tiles carry each layer's own channel count."""
    x, ws = _case(1, 1, (12, 12), [4, 8, 6])
    got = halo_conv_block(torch.from_numpy(x),
                          [torch.from_numpy(w) for w in ws], tiles=(2, 3))
    want = jax_block_ref(jnp.asarray(x), list(map(jnp.asarray, ws)))
    assert got.shape == (1, 12, 12, 6)
    assert _err(got, want) < TOL


def test_halo_conv_tiling_invariance():
    """The paper's property: the 2-core (1, 2) and 4-core (2, 2) tilings
    give the same block output."""
    x, ws = _case(3, 1, (16, 16), [8, 8, 8])
    tx, tw = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    y1 = halo_conv_block(tx, tw, tiles=(1, 2))
    y2 = halo_conv_block(tx, tw, tiles=(2, 2))
    assert _err(y1, y2) < 1e-5


@pytest.mark.parametrize("n_th,n_tw,r", [(2, 2, 2), (1, 2, 1), (2, 4, 3)])
def test_extract_tiles_matches_jax(n_th, n_tw, r):
    rng = np.random.default_rng(4)
    th, tw = 4, 3
    xp = rng.standard_normal(
        (2, n_th * th + 2 * r, n_tw * tw + 2 * r, 5)).astype(np.float32)
    got = _extract_tiles(torch.from_numpy(xp), n_th, n_tw, th, tw, r)
    want = jax_extract_tiles(jnp.asarray(xp), n_th, n_tw, th, tw, r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tiles_plain_version_keeps_f32_between_layers():
    """The kernel's function: f32 through every layer, one cast at the end
    (the Pallas kernel's), against the whole-image oracle in f32."""
    x, ws = _case(5, 1, (8, 8), [4, 4, 4])
    xp = np.pad(x, [(0, 0), (2, 2), (2, 2), (0, 0)])
    tiles = torch.from_numpy(xp).to(torch.bfloat16)
    wb = [torch.from_numpy(w).to(torch.bfloat16) for w in ws]
    got = halo_conv_block_tiles(tiles, wb, tile_h=8, tile_w=8)
    assert got.dtype == torch.bfloat16
    want = conv_block_ref(torch.from_numpy(x).to(torch.bfloat16).float(),
                          [w.float() for w in wb])
    f32 = halo_conv_block_tiles_ref(tiles.float(), [w.float() for w in wb])
    assert _err(f32, want) < TOL
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_halo_conv_rejects_bad_tiling():
    x = torch.zeros((1, 10, 10, 4))
    w = torch.zeros((3, 3, 4, 4))
    with pytest.raises(ValueError, match="must divide"):
        halo_conv_block(x, [w], tiles=(3, 2))
    with pytest.raises(ValueError, match="padded by"):
        halo_conv_block_tiles(torch.zeros((1, 9, 9, 4)), [w], tile_h=8,
                              tile_w=8)
