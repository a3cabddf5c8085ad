"""The port's mixture-of-experts FFN against the JAX ``moe_apply``.

Weights come from the JAX ``moe_init`` through ``params_from_numpy``,
activations from numpy seeds.  Tolerance: 1e-5 on f32 layer outputs and
1e-6 on the aux loss (f32 summation order only; the routing, capacity
drops and slots are exact and must agree).  bf16: one bf16 ulp of the
output's scale (2e-2 relative to max |y|), with the same routing.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.layers import common as JC
from repro.models.layers import ffn as JF
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import common as C
from repro_torch.models.layers import ffn as F

TOL = 1e-5
AUX_TOL = 1e-6
BF16_TOL = 2e-2


def _cfgs(router="softmax", n_shared=0, capacity_factor=1.25):
    out = []
    for get in (jax_smoke_config, get_smoke_config):
        cfg = get("deepseek-v2-236b")
        out.append(replace(cfg, moe=replace(
            cfg.moe, router=router, n_shared=n_shared,
            capacity_factor=capacity_factor)))
    return out


def _params(jcfg, seed=0, dtype=None):
    jp = JF.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if dtype == torch.bfloat16:
        jp = {k: v if k == "router" else
              jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
              for k, v in jp.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", dtype=dtype)
    return jp, tp


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _run(jcfg, tcfg, jp, tp, x, group_size):
    jy, jaux = JF.moe_apply(jp, jnp.asarray(x), jcfg, group_size=group_size)
    with torch.inference_mode():
        ty, taux = F.moe_apply(tp, torch.from_numpy(x), tcfg,
                               group_size=group_size)
    return np.asarray(jy), float(jaux), ty.numpy(), float(taux)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
@pytest.mark.parametrize("b,t,group_size", [
    (2, 16, 256),        # one group of 32 tokens
    (2, 13, 8),          # 26 tokens in groups of 8: two padded rows
    (1, 1, 256),         # a decode token
])
def test_moe_matches_jax(router, n_shared, capacity_factor, b, t,
                         group_size):
    jcfg, tcfg = _cfgs(router, n_shared, capacity_factor)
    jp, tp = _params(jcfg)
    jy, jaux, ty, taux = _run(jcfg, tcfg, jp, tp, _x(jcfg, b, t), group_size)
    assert ty.shape == jy.shape == (b, t, jcfg.d_model)
    assert np.abs(ty - jy).max() < TOL
    assert abs(taux - jaux) < AUX_TOL and taux > 0


def test_capacity_drops_tokens_as_jax_does():
    """At capacity 1.0 over 32 tokens some (token, k) pairs overflow their
    expert's buffer: the dropped ones fall through to the residual in both
    packages (the output differs from the uncapped one)."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _params(jcfg)
    x = _x(jcfg, 2, 16, seed=4)
    capped = _run(jcfg, tcfg, jp, tp, x, 256)
    ucfg, utcfg = _cfgs(capacity_factor=8.0)
    uncapped = _run(ucfg, utcfg, jp, tp, x, 256)
    assert np.abs(capped[2] - capped[0]).max() < TOL
    assert np.abs(capped[2] - uncapped[2]).max() > 1e-3


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_ties_take_the_lower_index_first(router):
    """``jax.lax.top_k`` puts the lower index first among equal scores; the
    port's stable sort does the same (``torch.topk`` promises no order)."""
    jcfg, tcfg = _cfgs(router)
    logits = np.array([[0.5, 2.0, 0.5, 2.0],
                       [1.0, 1.0, 1.0, 1.0],
                       [3.0, -1.0, 3.0, 3.0]], np.float32)
    jw, jidx, jprobs = JF._route(jcfg.moe, jnp.asarray(logits))
    tw, tidx, tprobs = F._route(tcfg.moe, torch.from_numpy(logits))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tidx.numpy(), [[1, 3], [0, 1], [0, 2]])
    assert np.abs(tw.numpy() - np.asarray(jw)).max() < 1e-7
    assert np.abs(tprobs.numpy() - np.asarray(jprobs)).max() < 1e-7


def test_zero_router_ties_every_expert():
    """A zero router ties every score: each token routes to experts 0 and
    1 in both packages, whose outputs agree, drops included."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    jy, jaux, ty, taux = _run(jcfg, tcfg, jp, tp, _x(jcfg, 1, 12), 256)
    assert np.abs(ty - jy).max() < TOL and abs(taux - jaux) < AUX_TOL


def test_moe_bf16_params_keep_the_router_f32():
    """bf16 params (the router kept in f32, as ``moe_init`` makes it): the
    router's logits are computed in the activations' dtype, routed in f32,
    and the layer agrees with the JAX one to bf16 rounding."""
    jcfg, tcfg = _cfgs(n_shared=2)
    jp, tp = _params(jcfg, dtype=torch.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["wg"].dtype == tp["shared"]["wd"].dtype == torch.bfloat16
    x = _x(jcfg, 2, 16)
    jy, jaux = JF.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    with torch.inference_mode():
        ty, taux = F.moe_apply(tp, torch.from_numpy(x).to(torch.bfloat16),
                               tcfg)
    assert ty.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    err = np.abs(ty.float().numpy() - jy).max()
    assert err < BF16_TOL * max(1.0, np.abs(jy).max())
    assert abs(float(taux) - float(jaux)) < 1e-4


def test_one_hot_out_of_range_is_zero_as_jax():
    idx = np.array([[-1, 0, 3], [4, 2, 7]], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.float32))
    got = F._one_hot(torch.from_numpy(idx), 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_softmax_f32_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = C.softmax_f32(torch.from_numpy(x).to(dtype))
        want = JC.softmax_f32(jnp.asarray(
            x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-7
