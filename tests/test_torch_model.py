"""The port's model against the JAX model on the same weights.

Weights come from the JAX ``init_params`` tree through
``params_from_numpy``; tokens (and a modality model's frame or patch
embeddings) are made with numpy.  Tolerance 2e-4 on logits: the
reference's own ``TOL`` (tests/test_decode_equivalence.py).  Tests that
hold decode against the full forward pin the MoE capacity high, as
tests/test_decode_equivalence.py does: capacity-based dispatch drops
different tokens for different token counts, so it is not causal under
drops.
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


def _uncap(cfg):
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    return cfg


def _pair(arch, window=0, uncap=False):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if window:
        jcfg = replace(jcfg, sliding_window=window)
        tcfg = replace(tcfg, sliding_window=window)
    if uncap:
        jcfg, tcfg = _uncap(jcfg), _uncap(tcfg)
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
    jfull, jaux = JM.forward(jp, jcfg, _jbatch(toks, mod))
    jpre, jcaches = JM.prefill(jp, jcfg, _jbatch(toks[:, :T], mod),
                               cache_len=64)
    jdec, _ = JM.decode_step(jp, jcfg, jcaches, jnp.asarray(toks[:, T:]),
                             jnp.int32(off + T))
    tt = torch.from_numpy(toks).long()
    with torch.inference_mode():
        tfull, taux = M.forward(tp, tcfg, _tbatch(toks, mod))
        tpre, tcaches = M.prefill(tp, tcfg, _tbatch(toks[:, :T], mod), 64)
        tdec, _ = M.decode_step(tp, tcfg, tcaches, tt[:, T:], off + T)
    assert tfull.shape == jfull.shape == \
        (2, off + T + 1, tcfg.padded_vocab)
    assert _err(tfull, jfull) < TOL
    assert _err(tpre, jpre) < TOL
    assert _err(tdec, jdec) < TOL
    # the MoE aux loss (0 without MoE layers), an f32 scalar
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert abs(float(taux) - float(jaux)) < 1e-6
    assert (float(jaux) > 0) == (jcfg.moe is not None)


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
    _, cfg, _, params = _pair(arch, uncap=True)
    toks = _tokens(cfg, (2, T + 1))
    mod, off = _modality(cfg, 2), M.prefix_len(cfg)
    tokens = torch.from_numpy(toks).long()
    with torch.inference_mode():
        full, _ = M.forward(params, cfg, _tbatch(toks, mod))
        pre, caches = M.prefill(params, cfg, _tbatch(toks[:, :T], mod), 64)
        assert float((pre[:, 0] - full[:, off + T - 1]).abs().max()) < TOL
        dec, _ = M.decode_step(params, cfg, caches, tokens[:, T:T + 1],
                               off + T)
        assert float((dec[:, 0] - full[:, off + T]).abs().max()) < TOL


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_multi_step_decode_chain(arch):
    """Three consecutive decode steps track the full forward and the JAX
    decode chain."""
    jcfg, cfg, jp, params = _pair(arch, uncap=True)
    toks = _tokens(cfg, (2, T + 3))
    mod, off = _modality(cfg, 2), M.prefix_len(cfg)
    tokens = torch.from_numpy(toks).long()
    _, jc = JM.prefill(jp, jcfg, _jbatch(toks[:, :T], mod), cache_len=32)
    with torch.inference_mode():
        full, _ = M.forward(params, cfg, _tbatch(toks, mod))
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
        full, _ = M.forward(params, cfg, {"tokens": tokens})
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
        logits, _ = M.forward(tp, tcfg, {"tokens": torch.from_numpy(
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
    ("deepseek-v2-236b", (60, 5120, 128, 128, 192, 12288, 102400)),
    ("deepseek-v3-671b", (61, 7168, 128, 128, 192, 18432, 129536)),
    ("jamba-1.5-large-398b", (72, 8192, 64, 8, 128, 24576, 65536)),
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


def test_unknown_mixer_raises_value_error():
    """Every mixer of the JAX package is ported; an unknown one raises
    ValueError, as the JAX ``layer_apply`` does."""
    cfg = replace(get_smoke_config("qwen2-0.5b"), n_layers=1,
                  stages=(StageDef((LayerDef("rwkv", "dense"),), 1),))
    with pytest.raises(ValueError, match="rwkv"):
        M.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="rwkv"):
        M.init_caches(cfg, 1, 8, device="cpu")


def test_stacked_init_equals_stack_of_layers():
    """A stage's params are made layer by layer into the stacked tensors:
    the same values as stacking the layers drawn in the same order."""
    from repro_torch.models import blocks
    cfg = get_smoke_config("seamless-m4t-medium")
    ld = cfg.stages[0].pattern[0]
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    got = blocks._stacked(3, lambda: blocks.layer_init(gens[0], ld, cfg,
                                                       torch.float32),
                          torch.device("cpu"))
    layers = [blocks.layer_init(gens[1], ld, cfg, torch.float32)
              for _ in range(3)]
    want = jax.tree.map(lambda *ls: torch.stack(ls), *layers)
    leaves = jax.tree.leaves(jax.tree.map(torch.equal, got, want))
    assert len(leaves) == 14 and all(leaves)       # cross and norm_x too


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "jamba-1.5-large-398b"])
def test_init_params_tree_matches_jax_moe_mla_mamba(arch):
    """Same keys, shapes and dtypes as the JAX tree, leaf for leaf (the MoE
    ``router`` and Mamba's ``a_log`` in f32 under a bf16 param dtype), and
    the JAX distributions' scales for the expert weights (scaled in
    place)."""
    jcfg = replace(jax_smoke_config(arch), param_dtype="bfloat16")
    cfg = replace(get_smoke_config(arch), param_dtype="bfloat16")
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
    moe = [layer["ffn"] for n in range(len(cfg.stages))
           for layer in tp[f"dec{n}"].values()
           if "router" in layer.get("ffn", {})][0]
    assert moe["router"].dtype == torch.float32
    for name, fan_in in (("wg", cfg.d_model), ("wd", cfg.moe.d_expert)):
        std = float(moe[name].float().std())
        assert abs(std - fan_in ** -0.5) < 0.05 * fan_in ** -0.5, name


def test_params_from_numpy_keeps_router_and_a_log_f32():
    """``router`` (MoE) and ``a_log`` (Mamba) are f32 by design in the JAX
    tree; a dtype cast keeps them so, and casts their neighbours."""
    jp = jax.tree.map(np.asarray, JM.init_params(
        jax_smoke_config("jamba-1.5-large-398b"), jax.random.PRNGKey(0)))
    tp = params_from_numpy(jp, "cpu", dtype=torch.bfloat16)
    stage = tp["dec0"]
    assert stage["p0"]["mixer"]["a_log"].dtype == torch.float32
    assert stage["p1"]["ffn"]["router"].dtype == torch.float32
    assert stage["p0"]["mixer"]["in_proj"].dtype == \
        stage["p1"]["ffn"]["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(stage["p0"]["mixer"]["a_log"].numpy(),
                                  jp["dec0"]["p0"]["mixer"]["a_log"])


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_stacked_one_repeat_makes_no_copy():
    """A one-repeat stage is the layer's own tensors viewed with a leading
    axis of 1: every stacked leaf shares its storage with the leaf
    ``make`` returned, so the layer is never held twice."""
    from repro_torch.models import blocks
    cfg = get_smoke_config("deepseek-v3-671b")
    ld = cfg.stages[1].pattern[0]                          # MLA + MoE
    made = []

    def make():
        made.append(blocks.layer_init(torch.Generator().manual_seed(3), ld,
                                      cfg, torch.float32))
        return made[-1]

    got = blocks._stacked(1, make, torch.device("cpu"))
    pairs = list(zip(_leaves(made[0]), _leaves(got), strict=True))
    assert len(made) == 1 and len(pairs) == 17      # shared experts too
    for layer, stacked in pairs:
        assert stacked.shape == (1, *layer.shape)
        assert stacked.data_ptr() == layer.data_ptr()
        assert stacked.untyped_storage().data_ptr() == \
            layer.untyped_storage().data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_repeats_draw_into_their_slots(monkeypatch, dtype):
    """Several repeats: the dry run draws nothing, and every random draw of
    every repeat lands in its slot of the stacked tensors; in f32 the draw
    itself writes there (``torch.randn(out=slot)``), so no layer-sized
    tensor is made beside the stack."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import common
    cfg = get_smoke_config("jamba-1.5-large-398b")
    ld = cfg.stages[0].pattern[1]                          # attn + MoE
    calls = []
    randn = torch.randn

    def spy(*args, **kw):
        calls.append(kw.get("out"))
        return randn(*args, **kw)

    monkeypatch.setattr(common.torch, "randn", spy)
    gen = torch.Generator().manual_seed(5)
    got = blocks._stacked(3, lambda: blocks.layer_init(gen, ld, cfg, dtype),
                          torch.device("cpu"))
    monkeypatch.undo()
    stacks = {t.untyped_storage().data_ptr() for t in _leaves(got)}
    n_draws = 8                  # attention 4, router 1, experts 3
    assert len(calls) == 3 * n_draws      # the dry run draws nothing
    into = [o for o in calls if o is not None]
    assert all(o.untyped_storage().data_ptr() in stacks for o in into)
    # bf16 leaves are drawn in f32 and cast into their slot; the f32 router
    # is drawn in place whatever the param dtype
    assert len(into) == (len(calls) if dtype == torch.float32 else 3)
    gen2 = torch.Generator().manual_seed(5)
    layers = [blocks.layer_init(gen2, ld, cfg, dtype) for _ in range(3)]
    want = jax.tree.map(lambda *ls: torch.stack(ls), *layers)
    assert all(jax.tree.leaves(jax.tree.map(torch.equal, got, want)))
