"""The port's AdamW (``repro_torch/training/optimizer.py``) against the JAX
package's on the same numpy trees: the learning-rate schedule, the global
norm, and the update with clipping on and off, the ``p.ndim > 1`` decay
rule on a stage's stacked leaves, and bfloat16 moments.

Tolerances: f32 arithmetic in both, in other orders and with other
``pow``/``cos`` implementations: 1e-6 relative on the schedule and the
norm, 1e-6 absolute on params and moments of magnitude about 1; bfloat16
moments within one bfloat16 ulp (2^-8 relative) of JAX's, both rounding
the same f32 value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as JO
from repro_torch.models.convert import opt_state_from_numpy, \
    params_from_numpy
from repro_torch.training import optimizer as TO

ATOL = 1e-6
BF16_REL = 2.0 ** -8


def _cfgs(**kw):
    return JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(warmup_steps=1, total_steps=8, lr=1e-3),
    dict(warmup_steps=0, total_steps=5), dict(warmup_steps=10,
                                              total_steps=10),
    dict(warmup_steps=3, total_steps=20, min_lr_frac=0.0)],
    ids=["default", "smoke", "no-warmup", "warmup-only", "to-zero"])
def test_lr_schedule_matches_jax(kw):
    jcfg, tcfg = _cfgs(**kw)
    for step in range(jcfg.total_steps + 6):
        want = float(JO.lr_schedule(jcfg, jnp.asarray(step, jnp.int32)))
        got = TO.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _tree(seed=0, scale=1.0):
    """A param-like tree with the shapes the decay rule sees: unstacked 1-d
    norm scales, a stage's stacked norm [repeats, d] and QKV bias
    [repeats, H, hd], matrices, an embedding."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (11, 8), "final_norm": {"scale": (8,)},
              "dec0": {"p0": {"norm1": {"scale": (2, 8)},
                              "mixer": {"wq": (2, 8, 4, 2), "bq": (2, 4, 2)}}},
              "bias1d": (5,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(shapes)


def test_global_norm_matches_jax():
    g = _tree(1)
    want = float(JO.global_norm(g))
    got = TO.global_norm(params_from_numpy(g, "cpu"))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(got) == pytest.approx(np.sqrt(sum(
        float(np.sum(np.square(leaf.astype(np.float64))))
        for leaf in jax.tree.leaves(g))), rel=1e-6)


def _run(kw, steps=3, grad_scale=1.0):
    """``steps`` AdamW updates with fresh gradients, in JAX and in the port
    (in place); returns both states (the port's copied) and metrics after
    each step."""
    jcfg, tcfg = _cfgs(**kw)
    jp = _tree(0)
    js = JO.init_opt_state(jcfg, jp)
    tp = params_from_numpy(jp, "cpu")
    ts = TO.init_opt_state(tcfg, tp)
    out = []
    for i in range(steps):
        g = _tree(10 + i, grad_scale)
        jp, js, jm = JO.adamw_update(jcfg, jp, g, js)
        tp2, ts2, tm = TO.adamw_update(tcfg, tp, params_from_numpy(g, "cpu"),
                                       ts)
        assert tp2 is tp and ts2 is ts            # updated in place
        copy = lambda t: TO.tree_map(torch.clone, t)  # noqa: E731
        out.append((jp, js, jm, copy(tp), copy(ts), tm))
    return out


def _close(got: torch.Tensor, want, atol=ATOL):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        w = want.astype(np.float32)
        g = got.float().numpy()
        assert got.dtype == torch.bfloat16
        assert np.all(np.abs(g - w) <= BF16_REL * np.abs(w) + 1e-30)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("clip", [1.0, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip, moments):
    # gradients of norm about 16: clipped to 1, or not at all
    for jp, js, jm, tp, ts, tm in _run(dict(grad_clip=clip,
                                            moment_dtype=moments,
                                            warmup_steps=1,
                                            total_steps=8, lr=1e-2)):
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(ts["step"]) == int(js["step"])
        assert ts["step"].dtype == torch.int32
        for got, want in zip(TO.tree_leaves(tp), jax.tree.leaves(jp),
                             strict=True):
            _close(got, want)
        for key in ("m", "v"):
            for got, want in zip(TO.tree_leaves(ts[key]),
                                 jax.tree.leaves(js[key]), strict=True):
                _close(got, want)


def test_weight_decay_skips_only_one_dimensional_leaves():
    """With zero gradients only the decay moves a param: every leaf with
    ndim > 1 shrinks by lr x wd x p, stacked norm scales and biases
    included (as the JAX rule does); the 1-d ones do not move."""
    tcfg = TO.AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                          total_steps=10)
    p = params_from_numpy(_tree(0), "cpu")
    before = [leaf.clone() for leaf in TO.tree_leaves(p)]
    zeros = TO.tree_map(torch.zeros_like, p)
    TO.adamw_update(tcfg, p, zeros, TO.init_opt_state(tcfg, p))
    lr = float(TO.lr_schedule(tcfg, torch.tensor(1)))
    for i, leaf in enumerate(TO.tree_leaves(p)):
        want = before[i] * (1 - lr * 0.5) if leaf.ndim > 1 else before[i]
        torch.testing.assert_close(leaf, want, rtol=1e-6, atol=1e-7)
    assert p["dec0"]["p0"]["norm1"]["scale"].ndim == 2    # stacked: decays
    assert p["final_norm"]["scale"].ndim == 1             # skipped


def test_init_opt_state_matches_jax_tree():
    for moments in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(moment_dtype=moments)
        js = JO.init_opt_state(jcfg, _tree(0))
        ts = TO.init_opt_state(tcfg, params_from_numpy(_tree(0), "cpu"))
        carried = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
        assert set(ts) == set(carried) == {"m", "v", "step"}
        for a, b in zip(TO.tree_leaves(ts), TO.tree_leaves(carried),
                        strict=True):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
