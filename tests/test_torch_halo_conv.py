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
from repro_torch.kernels.halo_conv2d.ops import (PASSES, _extract_tiles,
                                                 plan_block)
from repro_torch.kernels.halo_conv2d.ref import _leaky, conv2d_valid

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


# --------------------------------------------------------------------------- #
# The kernel's numerics, emulated in plain torch: the card's kernel cannot   #
# run here, so its split-operand scheme is held to the card's f32 tolerance  #
# (chip_smoke.py HALO_F32_TOL) at full channel width, K = 9 x Cin.           #
# --------------------------------------------------------------------------- #

HALO_F32_TOL = 1e-5


def _pieces(x, n):
    """x (f32) as n bf16 pieces (hi, mid, lo), each held in f32: the
    kernel's split."""
    out, r = [], x
    for _ in range(n):
        p = r.to(torch.bfloat16).float()
        out.append(p)
        r = r - p
    return out


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) by masking the low f32 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulate(tiles, ws, layer):
    """n layers, each ``layer(x, w, i)`` then leaky-ReLU, f32 between."""
    x = tiles.float()
    for i, w in enumerate(ws):
        x = _leaky(layer(x, w.float(), i), 0.1)
    return x


def _yolo_case(cin, dtype, hw=4, n_layers=2):
    """One padded tile at full channel width, He-scaled weights."""
    rng = np.random.default_rng(cin)
    ph = hw + 2 * n_layers
    tiles = torch.from_numpy(rng.standard_normal(
        (1, ph, ph, cin)).astype(np.float32)).to(dtype)
    ws = [torch.from_numpy(((2.0 / (9 * cin)) ** 0.5 * rng.standard_normal(
        (3, 3, cin, cin))).astype(np.float32)).to(dtype)
        for _ in range(n_layers)]
    return tiles, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin", [128, 256, 512])
def test_split_passes_meet_the_f32_tolerance(cin, dtype):
    """Three bf16 pieces per f32 operand and the kernel's passes (products
    of bf16 pieces are exact in f32) meet 1e-5 x max(1, max|y|) against the
    f32 plain version; a single bf16 or TF32 pass does not."""
    tiles, ws = _yolo_case(cin, dtype)
    plans = plan_block(1, tiles.shape[1], tiles.shape[2], [cin] * 3, dtype)
    assert set(PASSES[(3, 3)]) == {(a, b) for a in range(3)
                                   for b in range(3) if a + b <= 2}

    def split(x, w, i):
        plan = plans[i]
        xa, wb = _pieces(x, plan.a_planes), _pieces(w, plan.b_planes)
        assert plan.k_walk[2] == PASSES[(plan.a_planes, plan.b_planes)]
        return sum(conv2d_valid(xa[a], wb[b]) for a, b in plan.k_walk[2])

    want = halo_conv_block_tiles_ref(tiles.float(), [w.float() for w in ws])
    limit = HALO_F32_TOL * max(1.0, want.abs().max().item())
    got = _emulate(tiles, ws, split)
    assert (got - want).abs().max().item() <= limit
    one_bf16 = _emulate(tiles, ws, lambda x, w, i: conv2d_valid(
        _pieces(x, 1)[0], _pieces(w, 1)[0]))
    one_tf32 = _emulate(tiles, ws, lambda x, w, i: conv2d_valid(_tf32(x),
                                                                _tf32(w)))
    if dtype == torch.float32:
        assert (one_bf16 - want).abs().max().item() > limit
        assert (one_tf32 - want).abs().max().item() > limit
    else:
        # bf16 operands are exact in one plane; the f32 intermediate is not
        assert (one_bf16 - want).abs().max().item() > limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,chans", [(104, [128] * 3), (52, [256] * 3),
                                      (26, [512] * 2), (20, [3, 13, 13])])
def test_plan_k_walk_does_not_depend_on_the_tiling(hw, chans, dtype):
    """Exact tiling invariance on the card rests on every output element
    summing its terms in one K walk: the (1, 2) and (2, 2) tilings of each
    checked shape may pick other CTA tiles, never another K walk."""
    n = len(chans) - 1
    walks = {}
    for tiles in [(1, 2), (2, 2)]:
        th, tw = hw // tiles[0], hw // tiles[1]
        plans = plan_block(tiles[0] * tiles[1], th + 2 * n, tw + 2 * n,
                           chans, dtype)
        walks[tiles] = [(p.a_planes, p.b_planes, p.k_walk) for p in plans]
        for i, p in enumerate(plans):
            assert p.k_walk[1] == -(-chans[i] // p.k_walk[0])
    assert walks[(1, 2)] == walks[(2, 2)]
