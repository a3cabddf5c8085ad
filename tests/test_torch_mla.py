"""The port's multi-head latent attention against the JAX ``mla_apply``.

Weights come from the JAX ``mla_init`` through ``params_from_numpy``,
activations from numpy seeds.  The prefill runs the expanded form on the
flash op (its plain version on the CPU) at head dim nope + rope with V
zero-padded; decode runs the absorbed form over the latent cache.
Tolerance 1e-5 on f32 layer outputs (summation order only); the port-alone
twins of tests/test_layers_equivalence.py keep that file's tolerances.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.layers import mla as JL
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.models.layers import mla as L

TOL = 1e-5


def _setup(qlora=48):
    jcfg = jax_smoke_config("deepseek-v3-671b")
    tcfg = get_smoke_config("deepseek-v3-671b")
    jcfg = replace(jcfg, mla=replace(jcfg.mla, q_lora_rank=qlora))
    tcfg = replace(tcfg, mla=replace(tcfg.mla, q_lora_rank=qlora))
    jp = JL.mla_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _pos(t, start=0):
    return np.arange(start, start + t, dtype=np.int32)


@pytest.mark.parametrize("qlora", [0, 48])
@pytest.mark.parametrize("window", [0, 4])
def test_mla_prefill_matches_jax(qlora, window):
    jcfg, tcfg, jp, tp = _setup(qlora)
    x = _x(jcfg, 2, 11)
    jy, _ = JL.mla_apply(jp, jnp.asarray(x), jcfg,
                         positions=jnp.asarray(_pos(11)), window=window)
    with torch.inference_mode():
        ty, cache = L.mla_apply(tp, torch.from_numpy(x), tcfg,
                                positions=torch.from_numpy(_pos(11)),
                                window=window)
    assert cache is None and ty.shape == jy.shape
    assert np.abs(ty.numpy() - np.asarray(jy)).max() < TOL


def test_mla_prefill_runs_the_flash_op_at_nope_plus_rope(monkeypatch):
    """The expanded prefill is one flash call at D = nope + rope over
    H = KV heads (k_rope broadcast), V zero-padded to D; the padded output
    columns are zero and dropped."""
    jcfg, tcfg, jp, tp = _setup()
    m = tcfg.mla
    d = m.nope_head_dim + m.rope_head_dim
    seen = []

    def spy(q, k, v, q_pos, k_pos, **kw):
        out = flash_attention_ref(q, k, v, q_pos, k_pos, **kw)
        seen.append((q, k, v, out, kw))
        return out

    monkeypatch.setattr(L, "flash_attention", spy)
    with torch.inference_mode():
        L.mla_apply(tp, torch.from_numpy(_x(jcfg, 1, 9)), tcfg,
                    positions=torch.from_numpy(_pos(9)))
    (q, k, v, out, kw), = seen
    h = tcfg.n_heads
    assert q.shape == k.shape == v.shape == (1, 9, h, d)
    assert kw == {"causal": True, "window": 0}
    assert torch.equal(k[..., m.nope_head_dim:],
                       k[..., :1, m.nope_head_dim:].expand_as(
                           k[..., m.nope_head_dim:]))
    assert not v[..., m.v_head_dim:].any() and \
        not out[..., m.v_head_dim:].any()


@pytest.mark.parametrize("qlora", [0, 48])
@pytest.mark.parametrize("window,cache_len,steps", [
    (0, 16, 9),          # contiguous cache
    (4, 4, 9),           # rotating cache, slot pos % 4
    (0, 6, 9),           # past the cache's end: the last slot, clamped
])
def test_mla_absorbed_decode_matches_jax(qlora, window, cache_len, steps):
    """Token-by-token decode from an empty latent cache: outputs and the
    cache (c_kv, k_rope, slot positions) against the JAX chain."""
    jcfg, tcfg, jp, tp = _setup(qlora)
    x = _x(jcfg, 2, steps, seed=3)
    jc = JL.init_mla_cache(2, cache_len, jcfg, jnp.float32)
    tc = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for t in range(steps):
        jy, jc = JL.mla_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                              positions=jnp.asarray([t]), window=window,
                              cache=jc)
        with torch.inference_mode():
            ty, tc = L.mla_apply(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                 positions=torch.tensor([t],
                                                        dtype=torch.int32),
                                 window=window, cache=tc, pos=t)
        assert np.abs(ty.numpy() - np.asarray(jy)).max() < TOL, t
    want = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for name in ("c_kv", "k_rope"):
        assert float((tc[name] - want[name]).abs().max()) < TOL
    assert torch.equal(tc["positions"], want["positions"])


@pytest.mark.parametrize("qlora", [0, 48])
def test_mla_absorbed_decode_equals_naive(qlora):
    """Twin of tests/test_layers_equivalence.py on the port alone: the
    expanded prefill form equals the absorbed decode form token by
    token."""
    _, cfg, _, p = _setup(qlora)
    x = torch.from_numpy(_x(cfg, 2, 9))
    with torch.inference_mode():
        y_naive, _ = L.mla_apply(p, x, cfg, positions=torch.arange(
            9, dtype=torch.int32))
        cache = L.init_mla_cache(2, 16, cfg, torch.float32,
                                 torch.device("cpu"))
        outs = []
        for t in range(9):
            y, cache = L.mla_apply(p, x[:, t:t + 1], cfg,
                                   positions=torch.tensor([t],
                                                          dtype=torch.int32),
                                   cache=cache, pos=t)
            outs.append(y)
    np.testing.assert_allclose(y_naive.numpy(), torch.cat(outs, 1).numpy(),
                               atol=2e-5, rtol=2e-4)


def test_mla_cache_is_compressed():
    """Twin of tests/test_layers_equivalence.py: the cache stores rank-R
    latents and one shared RoPE key, not H x D keys and values."""
    cfg = get_smoke_config("deepseek-v3-671b")
    cache = L.init_mla_cache(1, 64, cfg, torch.float32, torch.device("cpu"))
    mla_elems = sum(v.numel() for k, v in cache.items() if k != "positions")
    full_kv = 2 * 64 * cfg.n_heads * cfg.resolved_head_dim
    assert mla_elems < 0.35 * full_kv
    assert cache["positions"].dtype == torch.int32 and \
        bool((cache["positions"] == -1).all())
