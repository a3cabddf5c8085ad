"""Head padding in the port: twins of tests/test_head_padding.py on the
port's model (the padded model computes what the unpadded one does), the
padded param tree equal to the JAX package's leaf for leaf, and the padded
port model's logits against the padded JAX model's.

Tolerances: 2e-5 between the padded and unpadded port models (as the JAX
twin: the padding adds zero terms only); 2e-4 on logits against JAX (the
reference's own, as tests/test_torch_model.py); padded params exactly.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import head_padding as JH
from repro.models import model as JM
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.head_padding import (
    _q_slot_map,
    pad_attn_params,
    pad_heads_config,
    padded_head_counts,
)
from repro_torch.training.optimizer import tree_leaves

TOL = 2e-5
JAX_TOL = 2e-4


def _gqa_cfg(smoke=get_smoke_config):
    # h=6, kv=2, group=3; pad to multiple 4 -> kv'=4, r=2, g'=2, h'=8
    cfg = smoke("llava-next-34b")
    return replace(cfg, n_heads=6, n_kv_heads=2,
                   head_dim=cfg.resolved_head_dim)


def _batch(cfg, b, t, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "modality_emb": rng.standard_normal(
                (b, cfg.n_modality_tokens, cfg.modality_embed_dim)).astype(
                    np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _params(cfg):
    return M.init_params(cfg, 0, device="cpu")


def test_padded_head_counts():
    assert padded_head_counts(56, 8, 16) == (64, 16)
    assert padded_head_counts(14, 2, 16) == (16, 16)
    assert padded_head_counts(9, 3, 16) == (48, 48)
    assert padded_head_counts(6, 2, 4) == (8, 4)
    assert padded_head_counts(14, 2, 8) == (16, 8)


def test_q_slot_map_covers_all_heads():
    for (h, kv, mult) in [(56, 8, 16), (14, 2, 16), (6, 2, 4), (9, 3, 16),
                          (14, 2, 8)]:
        h_p, kv_p = padded_head_counts(h, kv, mult)
        qmap = _q_slot_map(h, kv, h_p, kv_p)
        assert qmap == JH._q_slot_map(h, kv, h_p, kv_p)
        assert len(qmap) == h_p
        used = [s for s in qmap if s >= 0]
        assert sorted(used) == list(range(h))       # each orig head once
        # every valid q slot attends a copy of its original kv head
        r, g, g_p = kv_p // kv, h // kv, h_p // kv_p
        for slot, src in enumerate(qmap):
            if src >= 0:
                assert (slot // g_p) // r == src // g


@pytest.mark.parametrize("mult", [4, 8])
def test_forward_equivalence(mult):
    cfg = _gqa_cfg()
    cfg_p = pad_heads_config(cfg, mult)
    assert cfg_p.n_heads % mult == 0 and cfg_p.n_kv_heads % mult == 0
    params = _params(cfg)
    params_p = pad_attn_params(params, cfg, cfg_p)
    batch = _torch(_batch(cfg, 2, 12))
    logits, _ = M.forward(params, cfg, batch)
    logits_p, _ = M.forward(params_p, cfg_p, batch)
    torch.testing.assert_close(logits_p, logits, rtol=TOL, atol=TOL)


def test_decode_equivalence():
    cfg = _gqa_cfg()
    cfg_p = pad_heads_config(cfg, 4)
    params = _params(cfg)
    params_p = pad_attn_params(params, cfg, cfg_p)
    prompt = _torch(_batch(cfg, 1, 8))
    cache_len = 32
    logits, caches = M.prefill(params, cfg, prompt, cache_len)
    logits_p, caches_p = M.prefill(params_p, cfg_p, prompt, cache_len)
    torch.testing.assert_close(logits_p, logits, rtol=TOL, atol=TOL)
    pos = prompt["tokens"].shape[1] + cfg.n_modality_tokens
    tok = logits[:, -1:].argmax(-1)
    for step in range(3):
        out, caches = M.decode_step(params, cfg, caches, tok, pos + step)
        out_p, caches_p = M.decode_step(params_p, cfg_p, caches_p, tok,
                                        pos + step)
        torch.testing.assert_close(out_p, out, rtol=TOL, atol=TOL)
        tok = out[:, -1:].argmax(-1)


def test_mla_config_is_noop():
    cfg = get_config("deepseek-v2-236b")
    assert pad_heads_config(cfg, 16) is cfg


def _jax_pair(mult):
    jcfg = _gqa_cfg(jax_smoke_config)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = _gqa_cfg()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jcfg_p = JH.pad_heads_config(jcfg, mult)
    tcfg_p = pad_heads_config(tcfg, mult)
    assert (tcfg_p.n_heads, tcfg_p.n_kv_heads) == \
        (jcfg_p.n_heads, jcfg_p.n_kv_heads)
    return (jcfg_p, JH.pad_attn_params(jp, jcfg, jcfg_p),
            tcfg_p, pad_attn_params(tp, tcfg, tcfg_p))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("mult", [4, 8])
def test_padded_params_equal_jax(mult):
    _, jp, _, tp = _jax_pair(mult)
    jflat = dict(_flat(jax.tree.map(np.asarray, jp)))
    tflat = dict(_flat(tp))
    assert sorted(jflat) == sorted(tflat)
    for path, want in jflat.items():
        got = tflat[path].numpy()
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("mult", [4, 8])
def test_padded_logits_match_jax(mult):
    jcfg_p, jp, tcfg_p, tp = _jax_pair(mult)
    batch = _batch(tcfg_p, 2, 12)
    want, _ = JM.forward(jp, jcfg_p, batch)
    got, _ = M.forward(tp, tcfg_p, _torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JAX_TOL,
                               atol=JAX_TOL)


def test_padding_a_qkv_bias_model():
    """qwen2's smoke config (QKV bias) at 6/2 heads, padded to 4 and 8:
    the bias leaves move with their heads, and the logits do not
    change."""
    base = get_smoke_config("qwen2-0.5b")
    cfg = replace(base, n_heads=6, n_kv_heads=2,
                  head_dim=base.resolved_head_dim)
    assert cfg.qkv_bias
    params = _params(cfg)
    for leaf in tree_leaves(params):            # non-zero biases
        if leaf.ndim == 3 and leaf.shape[-1] == cfg.resolved_head_dim:
            leaf.normal_(generator=torch.Generator().manual_seed(3))
    for mult in (4, 8):
        cfg_p = pad_heads_config(cfg, mult)
        params_p = pad_attn_params(params, cfg, cfg_p)
        batch = _torch({"tokens": _batch(cfg, 2, 10)["tokens"]})
        torch.testing.assert_close(M.forward(params_p, cfg_p, batch)[0],
                                   M.forward(params, cfg, batch)[0],
                                   rtol=TOL, atol=TOL)
