"""The port's layers and plain kernel versions against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks; the
JAX side runs on the CPU (the Pallas decode kernel in interpret mode).
Tolerance 2e-5: the reference's own f32 kernel tolerance
(tests/test_kernels.py TOLS); the two frameworks differ only in
summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.decode_attention.kernel import decode_attention as \
    pallas_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref as \
    jax_decode_ref
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models.layers import attention as JA
from repro.models.layers import common as JC
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, \
    decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention, \
    flash_attention_ref
from repro_torch.models.layers import attention as TA
from repro_torch.models.layers import common as TC

TOL = 2e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(torch_out, jax_out, tol=TOL):
    got = torch_out.detach().float().numpy()
    want = np.asarray(jax_out, dtype=np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err < tol, err


# --------------------------------------------------------------------------- #
# common ops                                                                  #
# --------------------------------------------------------------------------- #


def test_rmsnorm():
    rng = _rng()
    x, s = _randn(rng, 2, 5, 24), _randn(rng, 24)
    _close(TC.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x),
                      1e-6),
           JC.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = _rng(1)
    x = _randn(rng, 2, 7, 3, 16)
    pos = np.arange(3, 10, dtype=np.int32)
    _close(TC.rope_freqs(16, theta), JC.rope_freqs(16, theta))
    tcos, tsin = TC.rope_cos_sin(torch.from_numpy(pos), 16, theta)
    jcos, jsin = JC.rope_cos_sin(jnp.asarray(pos), 16, theta)
    _close(tcos, jcos)
    _close(tsin, jsin)
    _close(TC.apply_rope(torch.from_numpy(x), tcos, tsin),
           JC.apply_rope(jnp.asarray(x), jcos, jsin))


def test_silu_and_swiglu():
    rng = _rng(2)
    g, u = _randn(rng, 4, 9), _randn(rng, 4, 9)
    _close(TC.silu(torch.from_numpy(g)), JC.silu(jnp.asarray(g)))
    _close(TC.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           JC.swiglu(jnp.asarray(g), jnp.asarray(u)))


def test_masked_softmax_zeroes_fully_masked_rows():
    rng = _rng(3)
    s = _randn(rng, 3, 6)
    mask = rng.random((3, 6)) > 0.4
    mask[1] = False                                  # a row with no key
    got = TC.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    _close(got, JC.masked_softmax(jnp.asarray(s), jnp.asarray(mask)))
    assert torch.all(got[1] == 0)


def test_initialisers_scale():
    gen = torch.Generator().manual_seed(0)
    w = TC.dense_init(gen, 256, 4, 64, dtype=torch.float32)
    assert w.shape == (256, 4, 64)
    assert abs(float(w.std()) - 256 ** -0.5) < 0.05 * 256 ** -0.5
    e = TC.normal_init(gen, (1000, 32), 0.02, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) \
        < 0.002


# --------------------------------------------------------------------------- #
# attention layer                                                             #
# --------------------------------------------------------------------------- #


def _attn_params(cfg, rng):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": _randn(rng, d, cfg.n_heads, hd) * d ** -0.5,
         "wk": _randn(rng, d, cfg.n_kv_heads, hd) * d ** -0.5,
         "wv": _randn(rng, d, cfg.n_kv_heads, hd) * d ** -0.5,
         "wo": _randn(rng, cfg.n_heads * hd, d) * (cfg.n_heads * hd) ** -0.5}
    if cfg.qkv_bias:     # non-zero, so that the bias path is exercised
        p["bq"] = 0.1 * _randn(rng, cfg.n_heads, hd)
        p["bk"] = 0.1 * _randn(rng, cfg.n_kv_heads, hd)
        p["bv"] = 0.1 * _randn(rng, cfg.n_kv_heads, hd)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("t", [8, 13])
def test_attn_apply_full_sequence(window, t):
    """GQA (4 query heads over 2 KV heads) with QKV bias, causal, with and
    without a sliding window, ragged T."""
    jcfg, tcfg = jax_smoke_config("qwen2-0.5b"), get_smoke_config("qwen2-0.5b")
    rng = _rng(4)
    jp, tp = _attn_params(jcfg, rng)
    x = _randn(rng, 2, t, jcfg.d_model)
    pos = np.arange(t, dtype=np.int32)
    want, _ = JA.attn_apply(jp, jnp.asarray(x), jcfg,
                            positions=jnp.asarray(pos), window=window)
    got, cache = TA.attn_apply(tp, torch.from_numpy(x), tcfg,
                               positions=torch.from_numpy(pos),
                               window=window)
    assert cache is None
    _close(got, want)
    _close(TA.attn_out_project(tp, got), JA.attn_out_project(jp, want))


def _cache(rng, cache_len, kv, hd, stored):
    k = _randn(rng, 2, cache_len, kv, hd)
    v = _randn(rng, 2, cache_len, kv, hd)
    p = np.broadcast_to(np.asarray(stored, np.int32), (2, cache_len)).copy()
    return {"k": k, "v": v, "positions": p}


@pytest.mark.parametrize("case", ["contiguous", "rotating", "clamp"])
def test_attn_apply_cache_decode(case):
    """One decode token against the cache: write slot, mask, attend.
    ``clamp``: no window and pos >= cache_len, where JAX's
    dynamic_update_slice clamps the write into the last slot."""
    jcfg, tcfg = jax_smoke_config("qwen2-0.5b"), get_smoke_config("qwen2-0.5b")
    rng = _rng(5)
    jp, tp = _attn_params(jcfg, rng)
    cache_len = 8
    if case == "contiguous":
        window, pos = 0, 5
        stored = [0, 1, 2, 3, 4, -1, -1, -1]
    elif case == "rotating":
        window, pos = 8, 21          # slot j holds the newest p < 21, p%8==j
        stored = [pos - 1 - ((pos - 1 - j) % 8) for j in range(8)]
    else:
        window, pos = 0, 11
        stored = list(range(8))
    c = _cache(rng, cache_len, jcfg.n_kv_heads, jcfg.resolved_head_dim,
               stored)
    x = _randn(rng, 2, 1, jcfg.d_model)
    want, jcache = JA.attn_apply(
        jp, jnp.asarray(x), jcfg, positions=jnp.asarray([pos], jnp.int32),
        window=window, cache={k: jnp.asarray(v) for k, v in c.items()})
    tcache = {k: torch.from_numpy(v.copy()) for k, v in c.items()}
    got, out_cache = TA.attn_apply(
        tp, torch.from_numpy(x), tcfg,
        positions=torch.tensor([pos], dtype=torch.int32), window=window,
        cache=tcache, pos=pos)
    assert out_cache is tcache                         # written in place
    _close(got, want)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    np.testing.assert_array_equal(tcache["positions"].numpy(),
                                  np.asarray(jcache["positions"]))
    if case == "clamp":
        assert int(tcache["positions"][0, -1]) == pos


def test_write_slot_clamps_like_dynamic_update_slice():
    assert TA._write_slot(8, 11, 0) == 7
    assert TA._write_slot(8, 11, 8) == 3
    assert TA._write_slot(8, 5, 0) == 5


# --------------------------------------------------------------------------- #
# plain kernel versions                                                       #
# --------------------------------------------------------------------------- #


def _decode_inputs(rng, b, h, kv, d, s, pos, window):
    q = _randn(rng, b, h, d)
    k = _randn(rng, b, s, kv, d)
    v = _randn(rng, b, s, kv, d)
    if window:
        row = np.array([pos - ((pos - j) % s) for j in range(s)], np.int32)
    else:
        row = np.where(np.arange(s) <= pos, np.arange(s), -1).astype(np.int32)
    positions = np.stack([row] * b)
    positions[-1, :3] = -1                            # some empty slots
    return q, k, v, positions


@pytest.mark.parametrize("window,pos", [(0, 100), (0, 127), (32, 300)])
def test_plain_decode_matches_jax_ref_and_pallas(window, pos):
    """S = 128 so the Pallas kernel runs (it needs S % 128 == 0)."""
    rng = _rng(6)
    q, k, v, positions = _decode_inputs(rng, 2, 14, 2, 64, 128, pos, window)
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, positions)),
                               pos, window=window)
    jargs = [jnp.asarray(a) for a in (q, k, v, positions)]
    _close(got, jax_decode_ref(*jargs, jnp.int32(pos), window=window))
    _close(got, pallas_decode_attention(*jargs, jnp.int32(pos),
                                        window=window, interpret=True))
    # the wrapper takes the plain version for CPU tensors, uncounted
    wrapped = decode_attention(*map(torch.from_numpy, (q, k, v, positions)),
                               pos, window=window)
    assert torch.equal(wrapped, got) and decode_attention.launches == 0


def test_plain_decode_ragged_cache_and_empty_row():
    """Any S works (no S % 128 rule); a head with no valid slot gives 0."""
    rng = _rng(7)
    q, k, v, positions = _decode_inputs(rng, 2, 4, 2, 16, 37, 20, 0)
    positions[0] = -1
    got = decode_attention_ref(*map(torch.from_numpy, (q, k, v, positions)),
                               20)
    assert torch.all(got[0] == 0)
    jq = jnp.asarray(q)
    mask = jnp.asarray((positions >= 0) & (positions <= 20))[:, None, None]
    want = JA._gqa_scores_to_out(jq[:, None], jnp.asarray(k), jnp.asarray(v),
                                 mask)[:, 0]
    _close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_plain_flash_matches_attention_ref_mha(causal, window):
    rng = _rng(8)
    b, t, h, d = 2, 16, 3, 32
    q, k, v = (_randn(rng, b, t, h, d) for _ in range(3))
    p = torch.arange(t, dtype=torch.int32)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), p, p,
                              causal=causal, window=window)
    tr = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)]
    want = jax_attention_ref(*tr, causal=causal, window=window)
    _close(got, want.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("t,window", [(13, 0), (13, 4), (37, 0)])
def test_plain_flash_matches_model_gqa(t, window):
    """GQA at ragged T against the JAX model's _gqa_scores_to_out."""
    rng = _rng(9)
    b, h, kv, d = 2, 14, 2, 64
    q = _randn(rng, b, t, h, d)
    k, v = _randn(rng, b, t, kv, d), _randn(rng, b, t, kv, d)
    p = np.arange(t, dtype=np.int32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v, p, p)),
                          window=window)
    mask = JA.causal_mask(jnp.asarray(p), jnp.asarray(p), window)[None, None]
    want = JA._gqa_scores_to_out(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), mask)
    _close(got, want)
    assert flash_attention.launches == 0


def test_causal_mask():
    qp = np.array([3, 4, 5], np.int32)
    kp = np.arange(6, dtype=np.int32)
    for window in (0, 2):
        got = TA.causal_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                             window)
        want = JA.causal_mask(jnp.asarray(qp), jnp.asarray(kp), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

