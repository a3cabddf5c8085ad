"""The port's training path against the JAX package's on the same weights,
data and optimizer state: ``cross_entropy``, ``loss_fn`` and
``make_train_step`` for every registered architecture (smoke configs),
and recompute (``remat``) changing nothing.

Weights and the optimizer state come from the JAX trees through
``params_from_numpy`` / ``opt_state_from_numpy``; batches from the JAX
``train_batches``.  On the CPU the port's attention takes the flash
kernel's plain forward and plain backward (``FlashAttentionFn``).

Tolerances (f32; the two differ in summation order only):
- loss, ce, aux: 1e-5 absolute (losses near 6);
- grad_norm: 1e-5 relative;
- each gradient leaf, and m after a step: 1e-4 of the leaf's max |g|;
  v after a step: 2e-4 of its max;
- params after step 1: 1e-5 absolute, except where a gradient element is
  near 0 (|g| <= 1e-4 of the leaf's max |g| at either step).  There the
  two sides may disagree on its sign, and Adam moves the element by lr x
  sign(g) on the first step, so the two may end up to 2 x lr apart a step;
  those elements are held to that bound and counted (under 0.1 %).
  Step 2's gradients, m and v are therefore taken at params that may
  differ by that much in a few elements, and are held to 1e-3 of their
  max instead (xLSTM's exponential gates move most: 1.1e-4 measured), and
  step 2's params to 1e-4 (its update divides m by sqrt(v) of both steps'
  gradients; one xLSTM element of 43,520 moved 1.15e-5).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import InputShape as JInputShape
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models.convert import opt_state_from_numpy, \
    params_from_numpy
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)
T, B = 12, 2
LOSS_TOL, NORM_TOL = 1e-5, 1e-5
PARAM_TOL = {1: 1e-5, 2: 1e-4}      # params, by step
GRAD_TOL = {1: 1e-4, 2: 1e-3}       # gradients and m, by step
V_TOL = {1: 2e-4, 2: 1e-3}
TINY = 1e-4                 # near-zero gradient, relative to the leaf's max


def _batches(jcfg, n):
    stream = JP.train_batches(jcfg, JInputShape("t", T, B, "train"))
    return [next(stream) for _ in range(n)]


def _setup(arch):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jopt, topt = JO.AdamWConfig(**OPT), TO.AdamWConfig(**OPT)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    js = JO.init_opt_state(jopt, jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    return jcfg, tcfg, jopt, topt, jp, js, tp, ts


def _rel(got, want, scale=None) -> float:
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max() if scale is None else scale
    diff = np.abs(np.asarray(got, np.float64) - want).max()
    return float(diff / max(scale, 1e-30))


def _torch_grads(tcfg, tp, batch, remat=True):
    loss, parts, grads = TS.loss_and_grads(tp, tcfg, batch, remat=remat)
    return loss, parts, list(TO.tree_leaves(grads))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_cross_entropy_masks_negative_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[0, 2:5] = -1
    labels[1, -1] = -1
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 33)
    got = TS.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), 33)
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) < LOSS_TOL
    # masked positions do not count: changing their logits changes nothing
    logits2 = logits.copy()
    logits2[0, 3] += 100.0
    assert float(TS.cross_entropy(torch.from_numpy(logits2),
                                  torch.from_numpy(labels), 33)) == \
        float(got)
    # all masked: 0 (the denominator is clamped at 1)
    none = np.full_like(labels, -1)
    assert float(TS.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(none), 33)) == 0.0


def test_loss_fn_modality_model_labels_text_positions_only():
    """llava's smoke model prepends its patches: of the T positions of the
    step (``text_len``: T minus min(n_modality_tokens, T // 2) patches),
    only the text positions carry labels."""
    jcfg, tcfg, _, _, jp, _, tp, _ = _setup("llava-next-34b")
    batch, = _batches(jcfg, 1)
    n_mod, n_text = batch["modality_emb"].shape[1], batch["labels"].shape[1]
    assert n_mod == min(jcfg.n_modality_tokens, T // 2) and \
        n_mod + n_text == T
    jl, jparts = JS.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    tl, tparts = TS.loss_fn(tp, tcfg, _tbatch(batch))
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert abs(float(tparts["ce"]) - float(jparts["ce"])) < LOSS_TOL
    # the CE is over the last T positions of the forward's logits
    logits, _ = TS.M.forward(tp, tcfg, _tbatch(batch))
    assert logits.shape[1] == T
    ce = TS.cross_entropy(logits[:, -n_text:], torch.from_numpy(
        batch["labels"]), tcfg.vocab_size)
    assert float(ce) == float(tparts["ce"])


def _check_state(step, tp, ts, jp, js, grads_seen, lr_sum):
    """m, v and params after a step against JAX's (see the module
    docstring for the near-zero-gradient elements)."""
    assert int(ts["step"]) == int(js["step"]) == step
    assert ts["step"].dtype == torch.int32
    names = jax.tree.leaves(jax.tree_util.tree_map_with_path(
        lambda p, _: jax.tree_util.keystr(p), jp))
    near_zero, total = 0, 0
    for i, (name, p, m, v, jpl, jm, jv) in enumerate(zip(
            names, TO.tree_leaves(tp), TO.tree_leaves(ts["m"]),
            TO.tree_leaves(ts["v"]), jax.tree.leaves(jp),
            jax.tree.leaves(js["m"]), jax.tree.leaves(js["v"]),
            strict=True)):
        gmax = max(np.abs(g[i]).max() for g in grads_seen)
        assert _rel(m, jm, gmax) < GRAD_TOL[step], (step, name)
        assert _rel(v, jv) < V_TOL[step], (step, name)
        tiny = np.zeros(p.shape, bool)
        for g in grads_seen:
            tiny |= np.abs(g[i]) <= TINY * np.abs(g[i]).max()
        diff = np.abs(p.detach().numpy() - np.asarray(jpl))
        assert diff[~tiny].max(initial=0.0) < PARAM_TOL[step], (step, name)
        assert diff.max() <= 2 * lr_sum + PARAM_TOL[step], (step, name)
        near_zero += int((diff[tiny] >= PARAM_TOL[step]).sum())
        total += diff.size
    assert near_zero <= 1e-3 * total, (step, near_zero, total)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch):
    """Two steps of each: loss, ce, aux and grad_norm; every gradient leaf
    of each step; then m, v and params after each step."""
    jcfg, tcfg, jopt, topt, jp, js, tp, ts = _setup(arch)
    jstep = JS.make_train_step(jcfg, jopt)
    tstep = TS.make_train_step(tcfg, topt, device="cpu")
    grads_seen, lr_sum = [], 0.0
    for step, batch in enumerate(_batches(jcfg, 2), 1):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads = jax.grad(lambda p: JS.loss_fn(p, jcfg, jbatch)[0])(jp)
        _, _, tgrads = _torch_grads(tcfg, tp, batch)
        grads_seen.append([np.asarray(g) for g in jax.tree.leaves(jgrads)])
        for g, w in zip(tgrads, grads_seen[-1], strict=True):
            assert _rel(g, w) < GRAD_TOL[step], (arch, step)
        jp, js, jm = jstep(jp, js, jbatch)
        tp, ts, tm = tstep(tp, ts, batch)
        for key in ("loss", "ce", "aux"):
            assert abs(float(tm[key]) - float(jm[key])) < LOSS_TOL, key
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < \
            NORM_TOL
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        lr_sum += float(jm["lr"])
        _check_state(step, tp, ts, jp, js, grads_seen, lr_sum)
    assert (float(tm["aux"]) > 0) == (jcfg.moe is not None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gives_the_same_gradients(arch):
    """Recomputing each layer repeat in the backward changes no gradient
    (the same operations run again on the same inputs)."""
    tcfg = get_smoke_config(arch)
    _, _, jopt, _, jp, _, _, _ = _setup(arch)
    batch, = _batches(jax_smoke_config(arch), 1)
    out = []
    for remat in (False, True):
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        loss, _, grads = _torch_grads(tcfg, tp, batch, remat=remat)
        out.append((float(loss), [g.numpy() for g in grads]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1], strict=True):
        np.testing.assert_array_equal(a, b)


def test_train_step_moe_group_size_reaches_the_router():
    """``moe_group_size`` is the MoE dispatch group of the train step's
    forward, as in the JAX step: a group of 4 tokens (capacity from 4)
    gives JAX's loss at the same group size, not the default's."""
    jcfg, tcfg, jopt, topt, jp, js, tp, ts = _setup("deepseek-v2-236b")
    batch, = _batches(jcfg, 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, _, jm = JS.make_train_step(jcfg, jopt, moe_group_size=4)(jp, js,
                                                                jbatch)
    _, _, tm = TS.make_train_step(tcfg, topt, moe_group_size=4,
                                  device="cpu")(tp, ts, batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
    assert abs(float(tm["aux"]) - float(jm["aux"])) < LOSS_TOL


def test_init_train_state_leaves_require_grad():
    cfg = replace(get_smoke_config("qwen2-0.5b"))
    params, state = TS.init_train_state(cfg, 0, device="cpu")
    leaves = list(TO.tree_leaves(params))
    assert all(p.requires_grad and p.is_leaf for p in leaves)
    assert set(state) == {"m", "v", "step"}
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    for p, m in zip(leaves, TO.tree_leaves(state["m"]), strict=True):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any()
