"""The port's encoder-decoder and modality-prefix paths against the JAX
package on the same weights and inputs: cross-attention, the encoder, the
modality projector and decoder input, the prefill caches (a cross layer's
encoder K/V included), and the prefill step and cost model that carry
``modality_emb``.

Weights come from the JAX init trees through ``params_from_numpy``; inputs
are made with numpy from a seed.  Tolerances: 2e-5 for layers, the
reference's own f32 kernel tolerance (tests/test_kernels.py TOLS); 2e-4 for
caches and logits, as tests/test_decode_equivalence.py.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.models.layers import attention as JA
from repro.training.steps import make_prefill_step as jax_prefill_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.models.layers import attention as TA
from repro_torch.serving.cost_model import measure_cost_model
from repro_torch.training.steps import make_prefill_step

TOL = 2e-5
LOGIT_TOL = 2e-4
SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
N_FRAMES = 6            # encoder frames of the seamless smoke model
T = 10                  # text tokens


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _x(shape, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err < tol, err


def _pair(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(_np(jp), "cpu")


def _inputs(cfg, b=2, t=T, seed=3):
    """Text tokens and the modality embeddings (llava: its prefix of
    patches; seamless: N_FRAMES frames), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    n = cfg.n_modality_tokens or N_FRAMES
    emb = _x((b, n, cfg.modality_embed_dim), seed + 1)
    return toks, emb


def _jbatch(toks, emb):
    return {"tokens": jnp.asarray(toks), "modality_emb": jnp.asarray(emb)}


def _tbatch(toks, emb):
    return {"tokens": _t(toks).long(), "modality_emb": _t(emb)}


# --------------------------------------------------------------------------- #
# Cross-attention                                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t", [1, 5])
def test_cross_kv_and_cross_attend_match_jax(bias, t):
    """Encoder K/V (with bias, no RoPE) and the unrotated, unmasked query
    side: a prompt's queries and a decode token's one."""
    jcfg = replace(jax_smoke_config(SEAMLESS), qkv_bias=bias)
    cfg = replace(get_smoke_config(SEAMLESS), qkv_bias=bias)
    jp = _np(JA.attn_init(jax.random.PRNGKey(1), jcfg, jnp.float32))
    for i, name in enumerate(("bq", "bk", "bv")):
        if bias:                               # zeros at init: make them real
            jp[name] = _x(jp[name].shape, 20 + i)
    tp = params_from_numpy(jp, "cpu")
    enc = _x((2, 7, cfg.d_model), 5)
    x = _x((2, t, cfg.d_model), 6)
    jkv = JA.cross_kv(jp, jnp.asarray(enc))
    tkv = TA.cross_kv(tp, _t(enc))
    for name in ("k", "v"):
        _close(tkv[name], jkv[name])
    _close(TA.cross_attend(tp, _t(x), tkv, cfg),
           JA.cross_attend(jp, jnp.asarray(x), jkv, jcfg))


# --------------------------------------------------------------------------- #
# Encoder, projector, decoder input                                           #
# --------------------------------------------------------------------------- #


def test_encode_matches_jax():
    """Two unmasked self-attention layers with RoPE at 0..S-1 and the final
    norm."""
    jcfg, cfg, jp, tp = _pair(SEAMLESS)
    enc_in = _x((2, N_FRAMES, cfg.d_model), 7)
    _close(M.encode(tp, cfg, _t(enc_in)),
           JM.encode(jp, jcfg, jnp.asarray(enc_in)))


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_project_modality_and_decoder_input_match_jax(arch):
    """The two projections with GELU between; llava's decoder input is the
    projected patches before the token embeddings, seamless's the tokens
    alone."""
    jcfg, cfg, jp, tp = _pair(arch)
    toks, emb = _inputs(cfg)
    _close(M.project_modality(tp, _t(emb)),
           JM.project_modality(jp, jnp.asarray(emb)))
    got = M._decoder_input(tp, cfg, _tbatch(toks, emb))
    want = JM._decoder_input(jp, jcfg, _jbatch(toks, emb))
    assert got.shape[1] == M.prefix_len(cfg) + T
    _close(got, want)


# --------------------------------------------------------------------------- #
# Prefill caches and decode                                                   #
# --------------------------------------------------------------------------- #


def _walk(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _walk(got[k], want[k], f"{path}/{k}")
        elif want[k].dtype == torch.int32:
            assert torch.equal(got[k], want[k]), f"{path}/{k}"
        else:
            assert got[k].shape == want[k].shape, f"{path}/{k}"
            assert float((got[k] - want[k]).abs().max()) < LOGIT_TOL, \
                f"{path}/{k}"


@pytest.mark.parametrize("arch,cache_len", [
    (SEAMLESS, 32),
    (LLAVA, 32),           # prefix + text fit
    (LLAVA, 12),           # they do not: only the last 12 positions stay
])
def test_prefill_caches_match_jax(arch, cache_len):
    """Every cache leaf against the JAX prefill's: K/V and slot positions
    of the self-attention, and a cross layer's encoder K/V [B, S, KV, hd]."""
    jcfg, cfg, jp, tp = _pair(arch)
    toks, emb = _inputs(cfg)
    jlog, jc = JM.prefill(jp, jcfg, _jbatch(toks, emb), cache_len=cache_len)
    with torch.inference_mode():
        tlog, tc = M.prefill(tp, cfg, _tbatch(toks, emb), cache_len)
    _close(tlog, jlog, LOGIT_TOL)
    want = caches_from_numpy(_np(jc), "cpu")
    _walk(tc, want)
    if arch == SEAMLESS:
        assert tc["dec0"]["p0"]["cross"]["k"].shape == \
            (cfg.n_layers, 2, N_FRAMES, cfg.n_kv_heads,
             cfg.resolved_head_dim)


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_prefill_then_decode_matches_forward(arch):
    """Prefill then three decode steps track the full forward (teacher
    forced) and the JAX decode chain; decode reads a cross layer's encoder
    K/V from the cache and takes no modality input."""
    jcfg, cfg, jp, tp = _pair(arch)
    toks, emb = _inputs(cfg, t=T + 3)
    off = M.prefix_len(cfg)
    cache_len = off + T + 3
    jfull, _ = JM.forward(jp, jcfg, _jbatch(toks, emb))
    _, jc = JM.prefill(jp, jcfg, _jbatch(toks[:, :T], emb),
                       cache_len=cache_len)
    tokens = _t(toks).long()
    with torch.inference_mode():
        full, _ = M.forward(tp, cfg, _tbatch(toks, emb))
        _close(full, jfull, LOGIT_TOL)
        pre, caches = M.prefill(tp, cfg, _tbatch(toks[:, :T], emb),
                                cache_len)
        assert float((pre[:, 0] - full[:, off + T - 1]).abs().max()) < \
            LOGIT_TOL
        for i in range(3):
            p = off + T + i
            dec, caches = M.decode_step(tp, cfg, caches,
                                        tokens[:, T + i:T + i + 1], p)
            jdec, jc = JM.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, T + i:T + i + 1]),
                                      jnp.int32(p))
            assert float((dec[:, 0] - full[:, p]).abs().max()) < LOGIT_TOL
            _close(dec, jdec, LOGIT_TOL)


# --------------------------------------------------------------------------- #
# Steps and cost model                                                        #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_prefill_step_passes_modality_emb(arch):
    """The step hands the whole batch on, so its greedy token is the JAX
    step's."""
    jcfg, cfg, jp, tp = _pair(arch)
    toks, emb = _inputs(cfg, b=1)
    nxt, caches = make_prefill_step(cfg, 32, device="cpu")(
        tp, _tbatch(toks, emb))
    jnxt, _ = jax_prefill_step(jcfg, 32)(jp, _jbatch(toks, emb))
    assert nxt.dtype == torch.int32 and int(nxt[0]) == int(jnxt[0])
    if arch == SEAMLESS:
        assert caches["dec0"]["p0"]["cross"]["k"].shape[2] == N_FRAMES


@pytest.mark.parametrize("arch", [SEAMLESS, LLAVA])
def test_measure_cost_model_builds_modality_emb(arch):
    cfg = get_smoke_config(arch)
    cm = measure_cost_model(cfg, prompt_len=4, cache_len=16, reps=2,
                            degrees=(2, 4), device="cpu")
    assert cm.prefill[1].mean_s > 0 and cm.decode[2].mean_s > 0
