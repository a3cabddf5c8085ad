"""The port's model against the JAX model on the same weights.

Weights come from the JAX ``init_params`` tree through
``params_from_numpy``; tokens are made with numpy.  Tolerance 2e-4 on
logits: the reference's own ``TOL`` (tests/test_decode_equivalence.py).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.models.config import LayerDef, StageDef
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.training.steps import make_prefill_step, make_serve_step

T = 12
TOL = 2e-4


def _pair(arch, window=0):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if window:
        jcfg = replace(jcfg, sliding_window=window)
        tcfg = replace(tcfg, sliding_window=window)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _err(t, j):
    return float(np.abs(t.detach().numpy() - np.asarray(j)).max())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, (2, T + 1))
    jfull, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    jpre, jcaches = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :T])},
                               cache_len=64)
    jdec, _ = JM.decode_step(jp, jcfg, jcaches, jnp.asarray(toks[:, T:]),
                             jnp.int32(T))
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        tfull = M.forward(tp, tcfg, {"tokens": tt})
        tpre, tcaches = M.prefill(tp, tcfg, {"tokens": tt[:, :T]}, 64)
        tdec, _ = M.decode_step(tp, tcfg, tcaches, tt[:, T:], T)
    assert tfull.shape == jfull.shape == (2, T + 1, tcfg.padded_vocab)
    assert _err(tfull, jfull) < TOL
    assert _err(tpre, jpre) < TOL
    assert _err(tdec, jdec) < TOL


@pytest.mark.parametrize("arch,cache_len,window,t", [
    ("qwen2-0.5b", 32, 0, 12),       # contiguous
    ("qwen2-0.5b", 8, 0, 12),        # contiguous, prompt longer than cache
    ("smollm-135m", 8, 8, 16),       # rotating
    ("smollm-135m", 32, 8, 16),      # window, prompt fits
])
def test_prefill_caches_match_jax(arch, cache_len, window, t):
    """_fill_kv / _scatter_tail write the same K/V and slot positions."""
    jcfg, tcfg, jp, tp = _pair(arch, window)
    toks = _tokens(jcfg, (2, t))
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                       cache_len=cache_len)
    with torch.inference_mode():
        _, tc = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                          cache_len)
    want = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for name in ("k", "v"):
        got = tc["dec0"]["p0"]["self"][name]
        assert got.shape == want["dec0"]["p0"]["self"][name].shape
        assert float((got - want["dec0"]["p0"]["self"][name]).abs().max()) \
            < 2e-5
    assert torch.equal(tc["dec0"]["p0"]["self"]["positions"],
                       want["dec0"]["p0"]["self"]["positions"])


# --------------------------------------------------------------------------- #
# Twin of tests/test_decode_equivalence.py on the port alone                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_matches_forward(arch):
    _, cfg, _, params = _pair(arch)
    tokens = torch.from_numpy(_tokens(cfg, (2, T + 1))).long()
    with torch.inference_mode():
        full = M.forward(params, cfg, {"tokens": tokens})
        pre, caches = M.prefill(params, cfg, {"tokens": tokens[:, :T]}, 64)
        assert float((pre[:, 0] - full[:, T - 1]).abs().max()) < TOL
        dec, _ = M.decode_step(params, cfg, caches, tokens[:, T:T + 1], T)
        assert float((dec[:, 0] - full[:, T]).abs().max()) < TOL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_multi_step_decode_chain(arch):
    """Three consecutive decode steps track the full forward and the JAX
    decode chain."""
    jcfg, cfg, jp, params = _pair(arch)
    toks = _tokens(cfg, (2, T + 3))
    tokens = torch.from_numpy(toks).long()
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :T])},
                       cache_len=32)
    with torch.inference_mode():
        full = M.forward(params, cfg, {"tokens": tokens})
        _, caches = M.prefill(params, cfg, {"tokens": tokens[:, :T]}, 32)
        for i in range(3):
            dec, caches = M.decode_step(params, cfg, caches,
                                        tokens[:, T + i:T + i + 1], T + i)
            jdec, jc = JM.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, T + i:T + i + 1]),
                                      jnp.int32(T + i))
            assert float((dec[:, 0] - full[:, T + i]).abs().max()) < TOL
            assert _err(dec, jdec) < TOL


def test_sliding_window_decode_matches_windowed_forward():
    """Rotating cache + window masks == full-seq sliding-window attention,
    and == the JAX rotating chain."""
    jcfg, cfg, jp, params = _pair("smollm-135m", window=8)
    toks = _tokens(cfg, (2, 21))
    tokens = torch.from_numpy(toks).long()
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :16])},
                       cache_len=8)
    with torch.inference_mode():
        full = M.forward(params, cfg, {"tokens": tokens})
        _, caches = M.prefill(params, cfg, {"tokens": tokens[:, :16]}, 8)
        for i in range(4):
            dec, caches = M.decode_step(params, cfg, caches,
                                        tokens[:, 16 + i:17 + i], 16 + i)
            jdec, jc = JM.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, 16 + i:17 + i]),
                                      jnp.int32(16 + i))
            assert float((dec[:, 0] - full[:, 16 + i]).abs().max()) < TOL
            assert _err(dec, jdec) < TOL


# --------------------------------------------------------------------------- #
# Steps, params, configs                                                      #
# --------------------------------------------------------------------------- #


def test_steps_greedy_decode_over_real_vocab():
    jcfg, cfg, jp, params = _pair("qwen2-0.5b")
    toks = _tokens(cfg, (1, 8))
    pre = make_prefill_step(cfg, 32, device="cpu")
    srv = make_serve_step(cfg, device="cpu")
    nxt, caches = pre(params, {"tokens": torch.from_numpy(toks)})
    assert nxt.dtype == torch.int32 and nxt.shape == (1,)
    last, caches = srv(params, caches, nxt[:, None], 8)
    assert last.shape == (1, 1) and 0 <= int(last) < cfg.vocab_size
    jlogits, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            cache_len=32)
    assert int(nxt[0]) == int(jnp.argmax(jlogits[0, -1, :jcfg.vocab_size]))


def test_init_params_tree_matches_jax():
    """Same keys, shapes and dtypes, leaf for leaf (stacked layers axis
    kept), and the JAX distributions' scales."""
    jcfg, cfg = jax_smoke_config("qwen2-0.5b"), get_smoke_config("qwen2-0.5b")
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    tp = M.init_params(cfg, 0, device="cpu")

    def walk(j, t, path=""):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], f"{path}/{k}")
            else:
                assert tuple(t[k].shape) == j[k].shape, f"{path}/{k}"
                assert str(t[k].dtype) == f"torch.{j[k].dtype}", f"{path}/{k}"

    walk(shapes, tp)
    wq = tp["dec0"]["p0"]["mixer"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002
    again = M.init_params(cfg, 0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])         # seeded


def test_params_from_numpy_bf16_and_dtype_cast():
    jcfg = jax_smoke_config("qwen2-0.5b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), jp)
    tp = params_from_numpy(bf, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(), np.asarray(bf["embed"], np.float32))
    cast = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                             dtype=torch.bfloat16)
    assert cast["dec0"]["p0"]["mixer"]["wq"].dtype == torch.bfloat16


def test_full_width_config_is_qwen2_0_5b():
    cfg = get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (24, 896, 14, 2, 64, 4864)
    assert cfg.padded_vocab == 152064 and cfg.qkv_bias and \
        cfg.tie_embeddings and cfg.param_dtype == "float32"


def test_unported_layers_raise_with_roadmap_pointer():
    cfg = replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                  stages=(StageDef((LayerDef("mamba", "dense"),), 1),))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.init_params(cfg, 0, device="cpu")
    cfg = replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                  stages=(StageDef((LayerDef("attn", "moe"),), 1),))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.init_params(cfg, 0, device="cpu")
