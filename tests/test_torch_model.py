"""The port's model against the JAX model on the same weights.

Weights come from the JAX ``init_params`` tree through
``params_from_numpy``; tokens (and a modality model's frame or patch
embeddings) are made with numpy.  Tolerance 2e-4 on logits: the
reference's own ``TOL`` (tests/test_decode_equivalence.py).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.models.config import LayerDef, StageDef
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.training.steps import make_prefill_step, make_serve_step

T = 12
TOL = 2e-4
N_FRAMES = 6            # encoder frames of an encoder-decoder smoke model


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


def _modality(cfg, b, seed=2):
    """A modality model's embeddings [b, S, modality_dim] from a seed: its
    n_modality_tokens patches, or N_FRAMES encoder frames; {} otherwise."""
    if not cfg.modality_embed_dim:
        return {}
    n = cfg.n_modality_tokens or N_FRAMES
    emb = 0.5 * np.random.default_rng(seed).standard_normal(
        (b, n, cfg.modality_embed_dim))
    return {"modality_emb": emb.astype(np.float32)}


def _jbatch(toks, mod):
    return {"tokens": jnp.asarray(toks),
            **{k: jnp.asarray(v) for k, v in mod.items()}}


def _tbatch(toks, mod):
    return {"tokens": torch.from_numpy(np.asarray(toks)).long(),
            **{k: torch.from_numpy(v) for k, v in mod.items()}}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, (2, T + 1))
    mod, off = _modality(jcfg, 2), M.prefix_len(jcfg)
    jfull, _ = JM.forward(jp, jcfg, _jbatch(toks, mod))
    jpre, jcaches = JM.prefill(jp, jcfg, _jbatch(toks[:, :T], mod),
                               cache_len=64)
    jdec, _ = JM.decode_step(jp, jcfg, jcaches, jnp.asarray(toks[:, T:]),
                             jnp.int32(off + T))
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        tfull = M.forward(tp, tcfg, _tbatch(toks, mod))
        tpre, tcaches = M.prefill(tp, tcfg, _tbatch(toks[:, :T], mod), 64)
        tdec, _ = M.decode_step(tp, tcfg, tcaches, tt[:, T:], off + T)
    assert tfull.shape == jfull.shape == \
        (2, off + T + 1, tcfg.padded_vocab)
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
    toks = _tokens(cfg, (2, T + 1))
    mod, off = _modality(cfg, 2), M.prefix_len(cfg)
    tokens = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full = M.forward(params, cfg, _tbatch(toks, mod))
        pre, caches = M.prefill(params, cfg, _tbatch(toks[:, :T], mod), 64)
        assert float((pre[:, 0] - full[:, off + T - 1]).abs().max()) < TOL
        dec, _ = M.decode_step(params, cfg, caches, tokens[:, T:T + 1],
                               off + T)
        assert float((dec[:, 0] - full[:, off + T]).abs().max()) < TOL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_multi_step_decode_chain(arch):
    """Three consecutive decode steps track the full forward and the JAX
    decode chain."""
    jcfg, cfg, jp, params = _pair(arch)
    toks = _tokens(cfg, (2, T + 3))
    mod, off = _modality(cfg, 2), M.prefix_len(cfg)
    tokens = torch.from_numpy(toks).long()
    _, jc = JM.prefill(jp, jcfg, _jbatch(toks[:, :T], mod), cache_len=32)
    with torch.inference_mode():
        full = M.forward(params, cfg, _tbatch(toks, mod))
        _, caches = M.prefill(params, cfg, _tbatch(toks[:, :T], mod), 32)
        for i in range(3):
            p = off + T + i
            dec, caches = M.decode_step(params, cfg, caches,
                                        tokens[:, T + i:T + i + 1], p)
            jdec, jc = JM.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, T + i:T + i + 1]),
                                      jnp.int32(p))
            assert float((dec[:, 0] - full[:, p]).abs().max()) < TOL
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


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_init_params_tree_matches_jax(arch):
    """Same keys, shapes and dtypes, leaf for leaf (stacked layers axis
    kept; the modality projector, encoder stages, ``enc_norm``, untied
    ``lm_head`` and the cross layers' ``cross``/``norm_x`` included), and
    the JAX distributions' scales."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
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


def test_params_from_numpy_keeps_f32_by_design_leaves():
    """An xLSTM tree keeps its gate projections and biases in f32 (as the
    JAX init makes them) when a dtype is asked for, whether the source tree
    is bf16 or f32 (xlstm-1.3b's own param dtype); the cast tree runs."""
    for src in ("bfloat16", "float32"):
        jcfg = replace(jax_smoke_config("xlstm-1.3b"), param_dtype=src)
        jp = jax.tree.map(np.asarray,
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
        for dtype in (torch.bfloat16, torch.float32):
            tp = params_from_numpy(jp, "cpu", dtype=dtype)
            mix, sl = tp["dec0"]["p0"]["mixer"], tp["dec0"]["p1"]["mixer"]
            for name in ("w_i", "w_f", "b_i", "b_f"):
                assert mix[name].dtype == torch.float32, (src, name)
            assert sl["b"].dtype == torch.float32, src
            assert mix["wq"].dtype == sl["r"].dtype == tp["embed"].dtype == \
                dtype
            np.testing.assert_array_equal(mix["w_i"].numpy(),
                                          jp["dec0"]["p0"]["mixer"]["w_i"])
    tcfg = replace(get_smoke_config("xlstm-1.3b"), param_dtype="bfloat16")
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)   # f32 source
    with torch.inference_mode():
        logits = M.forward(tp, tcfg, {"tokens": torch.from_numpy(
            _tokens(tcfg, (1, 4))).long()})
    assert torch.isfinite(logits.float()).all()


def test_params_from_numpy_casts_every_other_leaf():
    """Outside the xLSTM gates no leaf is f32 by design: every floating
    leaf of a qwen2 tree (its q/k/v biases included) takes the dtype."""
    jp = jax.tree.map(np.asarray, JM.init_params(
        jax_smoke_config("qwen2-0.5b"), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    leaves = jax.tree.leaves(tp)
    assert leaves and all(t.dtype == torch.bfloat16 for t in leaves)


def test_full_width_config_is_qwen2_0_5b():
    cfg = get_config("qwen2-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == (24, 896, 14, 2, 64, 4864)
    assert cfg.padded_vocab == 152064 and cfg.qkv_bias and \
        cfg.tie_embeddings and cfg.param_dtype == "float32"


def test_full_width_config_is_xlstm_1_3b():
    """48 layers, 6 x (7 mLSTM + 1 sLSTM), d=2048, 4 heads; the JAX tree
    holds 3,503,728,976 params (dense q/k/v; ModelConfig.param_count()
    counts them block-diagonal)."""
    cfg = get_config("xlstm-1.3b")
    pattern = cfg.stages[0].pattern
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.padded_vocab) == \
        (48, 2048, 4, 50688) and cfg.stages[0].repeats == 6
    assert [ld.mixer for ld in pattern] == ["mlstm"] * 7 + ["slstm"]
    assert cfg.tie_embeddings and cfg.param_dtype == "float32" and \
        cfg.mlstm_chunk == 0
    shapes = jax.eval_shape(lambda k: JM.init_params(jax_config(
        "xlstm-1.3b"), k), jax.ShapeDtypeStruct((2,), jnp.uint32))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) == \
        3_503_728_976 != cfg.param_count()


@pytest.mark.parametrize("arch,dims", [
    ("deepseek-7b", (30, 4096, 32, 32, 128, 11008, 102400)),
    ("phi3-mini-3.8b", (32, 3072, 32, 32, 96, 8192, 32256)),
    ("llava-next-34b", (60, 7168, 56, 8, 128, 20480, 64000)),
    ("seamless-m4t-medium", (12, 1024, 16, 16, 64, 4096, 256512)),
])
def test_full_width_config(arch, dims):
    """Layers, width, heads, KV heads, head dim, d_ff and padded vocab of
    the registered full-width config; none ties its embeddings, all are
    f32 with no QKV bias."""
    cfg = get_config(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == dims
    assert not cfg.tie_embeddings and not cfg.qkv_bias and \
        cfg.param_dtype == "float32"
    assert repr(cfg) == repr(jax_config(arch))      # field for field


def test_full_width_modality_configs():
    """llava prepends 2880 patch embeddings of 1024; seamless encodes
    frames of 1024 with 12 encoder layers under 12 cross-attending decoder
    layers; deepseek-7b and phi3-mini are plain decoders."""
    llava = get_config("llava-next-34b")
    assert (llava.modality_embed_dim, llava.n_modality_tokens) == \
        (1024, 2880) and not llava.is_encoder_decoder
    sm = get_config("seamless-m4t-medium")
    assert sm.is_encoder_decoder and sm.n_encoder_layers == 12 and \
        sm.modality_embed_dim == 1024 and sm.n_modality_tokens == 0
    assert [ld.cross_attn for st in sm.stages for ld in st.pattern] == \
        [True] and not any(ld.cross_attn for st in sm.encoder_stages
                           for ld in st.pattern)
    for arch in ("deepseek-7b", "phi3-mini-3.8b"):
        cfg = get_config(arch)
        assert not cfg.modality_embed_dim and not cfg.is_encoder_decoder
        assert [ld.mixer for st in cfg.stages for ld in st.pattern] == \
            ["attn"]


def test_unported_layers_raise_with_roadmap_pointer():
    cfg = replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                  stages=(StageDef((LayerDef("mamba", "dense"),), 1),))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.init_params(cfg, 0, device="cpu")
    cfg = replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                  stages=(StageDef((LayerDef("attn", "moe"),), 1),))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.init_params(cfg, 0, device="cpu")


def test_mla_mixer_raises_with_roadmap_pointer():
    cfg = replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                  stages=(StageDef((LayerDef("mla", "dense"),), 1),))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        M.init_params(cfg, 0, device="cpu")


def test_stacked_init_equals_stack_of_layers():
    """A stage's params are made layer by layer into the stacked tensors:
    the same values as stacking the layers drawn in the same order."""
    from repro_torch.models import blocks
    cfg = get_smoke_config("seamless-m4t-medium")
    ld = cfg.stages[0].pattern[0]
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    got = blocks._stacked(3, lambda: blocks.layer_init(gens[0], ld, cfg,
                                                       torch.float32))
    layers = [blocks.layer_init(gens[1], ld, cfg, torch.float32)
              for _ in range(3)]
    want = jax.tree.map(lambda *ls: torch.stack(ls), *layers)
    leaves = jax.tree.leaves(jax.tree.map(torch.equal, got, want))
    assert len(leaves) == 14 and all(leaves)       # cross and norm_x too
