"""The port's Mamba mixer against the JAX ``mamba_apply``.

Weights come from the JAX ``mamba_init`` through ``params_from_numpy``,
activations from numpy seeds.  The JAX prefill runs its chunked
associative scan with ``CHUNK`` monkeypatched small (so prompts span
several chunks and a padded last one), as its own test does; the port runs
its loop over time.  Tolerance 1e-5 on f32 layer outputs and states (the
two associate the same products differently); the port-alone twin of
tests/test_layers_equivalence.py keeps that file's tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.models.layers import mamba as JMb
from repro_torch.configs import get_smoke_config
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.models.layers import mamba as Mb

TOL = 1e-5
ARCH = "jamba-1.5-large-398b"


def _setup():
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = JMb.mamba_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _x(cfg, b, t, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _err(t, j):
    return float(np.abs(t.detach().numpy() - np.asarray(j)).max())


@pytest.mark.parametrize("t", [5, 17, 40])
def test_mamba_prefill_matches_jax_chunked_scan(t, monkeypatch):
    monkeypatch.setattr(JMb, "CHUNK", 16)
    jcfg, tcfg, jp, tp = _setup()
    x = _x(jcfg, 2, t)
    jy, _ = JMb.mamba_apply(jp, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        ty, cache = Mb.mamba_apply(tp, torch.from_numpy(x), tcfg)
    assert cache is None and ty.shape == jy.shape
    assert _err(ty, jy) < TOL


def test_mamba_decode_steps_match_jax():
    """Single-token steps from the zero cache: outputs, conv window and SSM
    state against the JAX decode chain."""
    jcfg, tcfg, jp, tp = _setup()
    x = _x(jcfg, 2, 7, seed=2)
    jc = JMb.init_mamba_cache(2, jcfg, jnp.float32)
    tc = caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    for i in range(7):
        jy, jc = JMb.mamba_apply(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                 cache=jc)
        with torch.inference_mode():
            ty, tc = Mb.mamba_apply(tp, torch.from_numpy(x[:, i:i + 1]),
                                    tcfg, cache=tc)
        assert _err(ty, jy) < TOL, i
    assert _err(tc["conv"], jc["conv"]) < TOL
    assert _err(tc["ssm"], jc["ssm"]) < TOL
    assert tc["ssm"].dtype == torch.float32


@pytest.mark.parametrize("t", [2, 17])
def test_mamba_filled_state_matches_jax_fill(t):
    """A prompt run from the fresh cache writes the final SSM state and
    the conv tail (zero-padded on the left when t < d_conv - 1) that the
    JAX ``_fill_mamba`` computes with its second recurrence, and gives the
    cacheless prefill's outputs."""
    jcfg, tcfg, jp, tp = _setup()
    x = _x(jcfg, 2, t, seed=5)
    jc = JMb.init_mamba_cache(2, jcfg, jnp.float32)
    want = JM._fill_mamba(jp, jnp.asarray(x), jcfg, jc)
    tc = Mb.init_mamba_cache(2, tcfg, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        ty, tc = Mb.mamba_apply(tp, torch.from_numpy(x), tcfg, cache=tc)
        plain, _ = Mb.mamba_apply(tp, torch.from_numpy(x), tcfg)
    assert _err(tc["conv"], want["conv"]) < TOL
    assert _err(tc["ssm"], want["ssm"]) < TOL
    assert torch.equal(ty, plain)


@pytest.mark.parametrize("t", [5, 17, 40])
def test_mamba_scan_equals_step(t):
    """Twin of tests/test_layers_equivalence.py on the port alone: the
    prompt's loop equals token-by-token decode."""
    _, cfg, _, p = _setup()
    x = torch.from_numpy(_x(cfg, 2, t))
    with torch.inference_mode():
        y_par, _ = Mb.mamba_apply(p, x, cfg)
        cache = Mb.init_mamba_cache(2, cfg, torch.float32,
                                    torch.device("cpu"))
        outs = []
        for i in range(t):
            y, cache = Mb.mamba_apply(p, x[:, i:i + 1], cfg, cache=cache)
            outs.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(outs, 1).numpy(),
                               atol=3e-5, rtol=3e-4)
