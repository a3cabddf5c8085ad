"""The port's model-layout kernel adapters against the JAX package's.

``cached_decode_attention``, ``mha_attention``, ``attention_ref``,
``slstm_hidden_states`` and ``maxpool2x2_ref``: the same numpy inputs from
a seed go through the JAX function and its counterpart in the port, on
CPU tensors.  The JAX adapters run their Pallas kernels in interpret mode
where they take them (the decode kernel at S % 128 == 0, the sLSTM scan),
and their oracles where the Pallas block does not divide the input; the
JAX flash kernel does not run on this jax (``pl.load`` is gone), so
``mha_attention`` is held against the JAX adapter's oracle branch.  The
port has no such branches: each adapter must also be bit-equal to the
plain version its wrapper dispatches to on the CPU, and count no launch.
The port's adapters take none of the JAX adapters' Pallas switches
(``use_pallas``, ``interpret``, ``block_t``): a call that asks for them
fails, where JAX would have taken its oracle.
Tolerance 2e-5 in f32, as tests/test_torch_layers.py; gradients relative
to their largest magnitude, as tests/test_torch_flash_bwd.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import cached_decode_attention as \
    jax_cached_decode_attention
from repro.kernels.flash_attention.ops import mha_attention as \
    jax_mha_attention
from repro.kernels.flash_attention.ref import attention_ref as \
    jax_attention_ref
from repro.kernels.halo_conv2d.ref import maxpool2x2_ref as jax_maxpool
from repro.kernels.slstm_scan import slstm_hidden_states as \
    jax_slstm_hidden_states
from repro_torch.kernels.decode_attention import cached_decode_attention, \
    decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention import attention_ref, \
    flash_attention, flash_attention_ref, mha_attention
from repro_torch.kernels.halo_conv2d import maxpool2x2_ref
from repro_torch.kernels.slstm_scan import slstm_hidden_states, slstm_scan, \
    slstm_scan_ref

TOL = 2e-5
BF16_TOL = 2e-2


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _err(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) if got.size else 0.0


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------- #
# cached_decode_attention                                                     #
# --------------------------------------------------------------------------- #


def _decode_inputs(rng, s, pos, window, b=2, h=8, kv=2, d=32):
    """q [B, 1, H, D], a cache of S slots and its positions: a rotating
    cache with a window (slot j holds the newest p <= pos with p % S == j),
    else 0..pos then empty; the last row's first 3 slots empty."""
    q = _randn(rng, b, 1, h, d)
    k = _randn(rng, b, s, kv, d)
    v = _randn(rng, b, s, kv, d)
    slots = np.arange(s)
    if window:
        row = pos - ((pos - slots) % s)
    else:
        row = np.where(slots <= pos, slots, -1)
    positions = np.stack([row.astype(np.int32)] * b)
    positions[-1, :3] = -1
    return q, k, v, positions


@pytest.mark.parametrize("s,pos,window", [
    pytest.param(128, 100, 0, id="S128-pallas"),
    pytest.param(128, 300, 48, id="S128-pallas-window"),
    pytest.param(37, 20, 0, id="S37-oracle"),
    pytest.param(37, 90, 16, id="S37-oracle-window"),
    pytest.param(200, 199, 0, id="S200-oracle"),
    pytest.param(200, 450, 64, id="S200-oracle-window"),
])
def test_cached_decode_attention_matches_jax(s, pos, window):
    """S = 128 runs the JAX adapter's Pallas kernel (interpret mode); S = 37
    and 200 its oracle.  The port launches its kernel at every S."""
    q, k, v, positions = _decode_inputs(np.random.default_rng(s + pos), s,
                                        pos, window)
    want = jax_cached_decode_attention(
        *map(jnp.asarray, (q, k, v, positions)), jnp.int32(pos),
        window=window, use_pallas=True, interpret=True)
    args = tuple(map(_t, (q, k, v, positions)))
    got = cached_decode_attention(*args, pos, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert _err(got, want) < TOL
    plain = decode_attention_ref(args[0][:, 0], *args[1:], pos,
                                 window=window)[:, None]
    assert torch.equal(got, plain)
    # a 0-d tensor position changes nothing; the Pallas switches are refused
    again = cached_decode_attention(*args, torch.tensor(pos), window=window)
    assert torch.equal(again, got)
    with pytest.raises(TypeError, match="use_pallas"):
        cached_decode_attention(*args, pos, window=window, use_pallas=False)
    assert decode_attention.launches == 0


# --------------------------------------------------------------------------- #
# mha_attention, attention_ref                                                #
# --------------------------------------------------------------------------- #


def _mha_inputs(t, seed, b=2, h=4, d=32):
    rng = np.random.default_rng(seed)
    return tuple(_randn(rng, b, t, h, d) for _ in range(3))


MASKS = [pytest.param(True, 0, id="causal"),
         pytest.param(True, 5, id="window"),
         pytest.param(False, 0, id="unmasked"),
         pytest.param(False, 5, id="unmasked-window-ignored")]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("t,use_pallas", [
    pytest.param(13, True, id="T13-oracle"),
    pytest.param(200, True, id="T200-oracle"),
    pytest.param(16, False, id="T16-ref"),
])
def test_mha_attention_matches_jax(t, use_pallas, causal, window):
    """T=13 and T=200 are where the JAX adapter with ``use_pallas=True``
    takes its oracle (T % bq != 0); at T=16 its Pallas kernel would run,
    which this jax cannot, so it is asked for the oracle."""
    q, k, v = _mha_inputs(t, t)
    want = jax_mha_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window, use_pallas=use_pallas,
                             interpret=True)
    args = tuple(map(_t, (q, k, v)))
    got = mha_attention(*args, causal=causal, window=window)
    assert _err(got, want) < TOL
    p = torch.arange(t, dtype=torch.int32)
    assert torch.equal(got, flash_attention_ref(*args, p, p, causal=causal,
                                                window=window))
    with pytest.raises(TypeError, match="use_pallas"):
        mha_attention(*args, causal=causal, window=window, use_pallas=False)
    assert flash_attention.launches == 0


@pytest.mark.parametrize("causal,window", MASKS[:3])
def test_mha_attention_gradient_matches_jax_vjp(causal, window):
    """The port's adapter is differentiable (through ``FlashAttentionFn``,
    whose backward is the plain backward on the CPU): its gradients
    against ``jax.vjp`` of the JAX adapter at T=16."""
    q, k, v = _mha_inputs(16, 3)
    do = _randn(np.random.default_rng(4), *q.shape)
    _, vjp = jax.vjp(lambda a, b, c: jax_mha_attention(
        a, b, c, causal=causal, window=window, use_pallas=False),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    args = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = mha_attention(*args, causal=causal, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, args, _t(do))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < TOL


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_ref_matches_jax(dtype, causal, window):
    """The [B, H, T, D] oracle: f32 math, the output in q's dtype."""
    rng = np.random.default_rng(9)
    q, k, v = (_randn(rng, 2, 3, 24, 16) for _ in range(3))
    want = jax_attention_ref(*(jnp.asarray(x).astype(dtype)
                               for x in (q, k, v)),
                             causal=causal, window=window)
    tdt = getattr(torch, dtype)
    got = attention_ref(*(_t(x).to(tdt) for x in (q, k, v)), causal=causal,
                        window=window)
    assert got.dtype == tdt and str(want.dtype) == dtype
    assert _err(got, want) < (TOL if dtype == "float32" else BF16_TOL)


# --------------------------------------------------------------------------- #
# slstm_hidden_states                                                         #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("t,block_t", [
    pytest.param(16, 8, id="T16-block8"),
    pytest.param(13, 8, id="T13-block8-padded"),
    pytest.param(13, 128, id="T13-block128-padded"),
])
def test_slstm_hidden_states_matches_jax(t, block_t):
    """The JAX adapter runs its Pallas scan in interpret mode, padding T
    to its block; the port runs no padded step (it takes no ``block_t``),
    and its hidden states are the scan's from (0, 0, 1, 0)."""
    b, h, dh = 2, 2, 16
    rng = np.random.default_rng(t + block_t)
    wx = (0.5 * rng.standard_normal((b, t, 4, h, dh))).astype(np.float32)
    r = (dh ** -0.5 * rng.standard_normal((4, h, dh, dh))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((4, h, dh))).astype(np.float32)
    want = jax_slstm_hidden_states(*map(jnp.asarray, (wx, r, bias)),
                                   use_pallas=True, block_t=block_t,
                                   interpret=True)
    args = tuple(map(_t, (wx, r, bias)))
    hs = slstm_hidden_states(*args)
    assert hs.dtype == torch.float32 and hs.shape == (b, t, h, dh)
    assert _err(hs, want[:, :t]) < TOL
    assert torch.equal(hs, slstm_scan_ref(*args)[0])
    with pytest.raises(TypeError, match="block_t"):
        slstm_hidden_states(*args, block_t=block_t)
    assert slstm_scan.launches == 0


# --------------------------------------------------------------------------- #
# maxpool2x2_ref                                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (1, 7, 9, 5), (3, 2, 2, 1)],
                         ids=["even", "odd-dropped", "one-window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool2x2_ref_matches_jax(shape, dtype):
    """A max takes no rounding: the port's result equals JAX's exactly."""
    x = _randn(np.random.default_rng(sum(shape)), *shape)
    want = jax_maxpool(jnp.asarray(x).astype(dtype))
    got = maxpool2x2_ref(_t(x).to(getattr(torch, dtype)))
    n, h, w, c = shape
    assert got.shape == (n, h // 2, w // 2, c)
    assert got.dtype == getattr(torch, dtype)
    assert _err(got, want) == 0.0
