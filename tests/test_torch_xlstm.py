"""The port's xLSTM layers and sLSTM scan (plain route on the CPU) against
the JAX package on the same inputs.

Inputs and weights are made with numpy from a seed (or taken from the JAX
init tree) and handed to both frameworks.  Tolerances: 2e-5 in f32 and
2e-2 in bf16 for the scan, the reference's own kernel tolerances
(tests/test_kernels.py TOLS); 2e-5 / 2e-4 (atol / rtol) for the layers as
tests/test_layers_equivalence.py; 2e-4 on logits as
tests/test_decode_equivalence.py.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.slstm_scan.kernel import slstm_scan as pallas_slstm_scan
from repro.kernels.slstm_scan.ref import slstm_scan_ref as jax_slstm_scan_ref
from repro.models import model as JM
from repro.models.layers import common as JC
from repro.models.layers import xlstm as JX
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_ref
from repro_torch.models import model as M
from repro_torch.models.config import LayerDef, StageDef
from repro_torch.models.convert import caches_from_numpy, params_from_numpy
from repro_torch.models.layers import common as TC
from repro_torch.models.layers import xlstm as TX

ARCH = "xlstm-1.3b"
TOL = 2e-5
LOGIT_TOL = 2e-4


def _cfgs():
    return jax_smoke_config(ARCH), get_smoke_config(ARCH)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(t, j):
    got = t.detach().float().numpy()
    want = np.asarray(j, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max())


def _close(t, j, atol=TOL, rtol=10 * TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32),
                               atol=atol, rtol=rtol)


def _x(shape, seed=1):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def _mixer(kind, seed=0):
    jcfg, cfg = _cfgs()
    init = JX.mlstm_init if kind == "mlstm" else JX.slstm_init
    jp = init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, cfg, jp, params_from_numpy(_np(jp), "cpu")


# --------------------------------------------------------------------------- #
# common                                                                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_heads(dtype):
    x = 3.0 * _x((2, 5, 3, 16)) + 1.0
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    got, want = TC.groupnorm_heads(tx), JC.groupnorm_heads(jx)
    assert got.dtype == tx.dtype
    _close(got, want.astype(jnp.float32),
           atol=TOL if dtype == "float32" else 2e-2, rtol=0)


# --------------------------------------------------------------------------- #
# mLSTM                                                                       #
# --------------------------------------------------------------------------- #


def test_mlstm_parallel_matches_jax():
    jcfg, cfg, jp, tp = _mixer("mlstm")
    x = _x((2, 11, cfg.d_model))
    want, _ = JX.mlstm_apply(jp, jnp.asarray(x), jcfg)
    got, cache = TX.mlstm_apply(tp, _t(x), cfg)
    assert cache is None
    _close(got, want)


def test_mlstm_recurrent_matches_jax():
    """Three decode steps from a non-trivial cache: outputs and the cache
    (updated in place in the port) agree."""
    jcfg, cfg, jp, tp = _mixer("mlstm")
    rng = np.random.default_rng(2)
    jc = JX.init_mlstm_cache(2, jcfg, jnp.float32)
    jc = {"conv": jnp.asarray(_x(jc["conv"].shape, 3)),
          "c": jnp.asarray(_x(jc["c"].shape, 4)),
          "n": jnp.asarray(np.abs(_x(jc["n"].shape, 5))),
          "m": jnp.asarray(rng.uniform(-2, 2, jc["m"].shape)
                           .astype(np.float32))}
    tc = caches_from_numpy(_np(jc), "cpu")
    x = _x((2, 3, cfg.d_model), 6)
    for t in range(3):
        want, jc = JX.mlstm_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  cache=jc)
        got, same = TX.mlstm_apply(tp, _t(x[:, t:t + 1]), cfg, cache=tc)
        assert same is tc
        _close(got, want)
    for name in ("conv", "c", "n", "m"):
        _close(tc[name], jc[name])


def test_mlstm_parallel_equals_recurrent():
    """Twin of tests/test_layers_equivalence.py on the port alone."""
    _, cfg, _, p = _mixer("mlstm")
    x = _t(_x((2, 11, cfg.d_model)))
    y_par, _ = TX.mlstm_apply(p, x, cfg)
    cache = TX.init_mlstm_cache(2, cfg, torch.float32, torch.device("cpu"))
    outs = [TX.mlstm_apply(p, x[:, t:t + 1], cfg, cache=cache)[0]
            for t in range(11)]
    torch.testing.assert_close(y_par, torch.cat(outs, 1), atol=2e-5,
                               rtol=2e-4)


def _chunk_inputs(cfg, t, seed=11):
    """q/k/v [2, t, H, dh] and f32 gate pre-activations [2, t, H] from a
    seed, in both frameworks."""
    rng = np.random.default_rng(seed)
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    h = cfg.n_heads
    qkv = [(rng.standard_normal((2, t, h, di // h))).astype(np.float32)
           for _ in range(3)]
    i_pre = rng.uniform(-3, 3, (2, t, h)).astype(np.float32)
    f_pre = rng.uniform(-1, 5, (2, t, h)).astype(np.float32)
    arrays = (*qkv, i_pre, f_pre)
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(_t(a) for a in arrays))


@pytest.mark.parametrize("t,chunk", [
    (12, 4),               # T % chunk == 0
    (9, 3),                # three full chunks
    (11, 4),               # ragged: the JAX form pads the last chunk
    (5, 8),                # one short chunk
])
def test_mlstm_chunked_matches_jax(t, chunk):
    """h_out and m_t against the JAX ``_mlstm_chunked`` on the same inputs;
    the final (C, n, m) too where no padded step decays the JAX carry."""
    _, cfg = _cfgs()
    jin, tin = _chunk_inputs(cfg, t)
    jh, jm, jfinal = JX._mlstm_chunked(*jin, chunk)
    th, tm, tfinal = TX._mlstm_chunked(*tin, chunk)
    assert th.dtype == torch.float32
    _close(th, jh)
    _close(tm, jm)
    if t % chunk == 0:
        for got, want in zip(tfinal, jfinal):
            _close(got, want)


@pytest.mark.parametrize("t", [11, 12])
def test_mlstm_chunked_final_state_matches_recurrence(t):
    """The chunked form's final state (ragged T included) equals the JAX
    prefill's per-token recurrence (``model._fill_mlstm``) on the same
    normed input."""
    jcfg, cfg, jp, tp = _mixer("mlstm")
    h = _x((2, t, cfg.d_model), 13)
    want = JM._fill_mlstm(jp, jnp.asarray(h), jcfg,
                          JX.init_mlstm_cache(2, jcfg, jnp.float32))
    di = tp["skip"].shape[0]
    xi_raw = torch.matmul(_t(h), tp["up_proj"])[..., :di]
    xi = TC.silu(TX._conv_causal(tp["conv_w"], tp["conv_b"], xi_raw, None))
    _, _, (c, n, m) = TX._mlstm_chunked(*TX._qkv_gates(tp, xi), 4)
    for name, got in zip("cnm", (c, n, m)):
        _close(got, want[name])


@pytest.mark.parametrize("t", [11, 12])
def test_mlstm_apply_chunked_form_matches_jax(t):
    """With ``mlstm_chunk`` set and T > chunk the layer runs the chunked
    form: its output matches the JAX layer's (which runs its own chunked
    form) and the parallel form's."""
    jcfg, cfg, jp, tp = _mixer("mlstm")
    jcfg, ccfg = replace(jcfg, mlstm_chunk=4), replace(cfg, mlstm_chunk=4)
    x = _x((2, t, cfg.d_model), 14)
    want, _ = JX.mlstm_apply(jp, jnp.asarray(x), jcfg)
    got, cache = TX.mlstm_apply(tp, _t(x), ccfg)
    assert cache is None
    _close(got, want)
    parallel, _ = TX.mlstm_apply(tp, _t(x), cfg)
    torch.testing.assert_close(got, parallel, atol=2e-5, rtol=2e-4)


# --------------------------------------------------------------------------- #
# sLSTM scan                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype,b,t,h,dh,block_t", [
    ("float32", 2, 32, 2, 16, 8),
    ("float32", 1, 40, 1, 32, 16),     # ragged: 40 % 16 != 0
    ("float32", 3, 16, 4, 8, 16),      # single block
    ("bfloat16", 2, 24, 2, 16, 8),
])
def test_slstm_scan_matches_pallas_and_ref(dtype, b, t, h, dh, block_t):
    """The shapes of tests/test_kernels.py::test_slstm_scan_sweep."""
    rng = np.random.default_rng(0)
    wx = (0.5 * rng.standard_normal((b, t, 4, h, dh))).astype(np.float32)
    r = (dh ** -0.5 * rng.standard_normal((4, h, dh, dh))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((4, h, dh))).astype(np.float32)
    jargs = (jnp.asarray(wx).astype(dtype), jnp.asarray(r).astype(dtype),
             jnp.asarray(bias))
    pallas = pallas_slstm_scan(*jargs, block_t=block_t, interpret=True)
    oracle = jax_slstm_scan_ref(*jargs)
    tdt = getattr(torch, dtype)
    hs, state = slstm_scan(_t(wx).to(tdt), _t(r).to(tdt), _t(bias))
    assert hs.dtype == torch.float32 and hs.shape == (b, t, h, dh)
    tol = TOL if dtype == "float32" else 2e-2
    assert _err(hs, pallas) < tol
    assert _err(hs, oracle) < tol
    assert torch.equal(state[0], hs[:, -1])


def _fill_case(t, seed=7):
    jcfg, cfg, jp, tp = _mixer("slstm")
    h = _x((2, t, cfg.d_model), seed)
    jcache = JX.init_slstm_cache(2, jcfg, jnp.float32)
    want = JM._fill_slstm(jp, jnp.asarray(h), jcfg, jcache)
    d = cfg.d_model
    wx = torch.matmul(_t(h), tp["w"].reshape(d, -1)).view(
        2, t, 4, cfg.n_heads, d // cfg.n_heads)
    return tp, wx, want


@pytest.mark.parametrize("t", [12, 40])
def test_slstm_final_state_matches_jax_fill(t):
    """The scan's final state is the state after the last real step (no
    padded steps), equal to the JAX prefill's second recurrence."""
    tp, wx, want = _fill_case(t)
    _, (h, c, n, m) = slstm_scan(wx, tp["r"], tp["b"])
    for name, got in zip("hcnm", (h, c, n, m)):
        assert _err(got, want[name]) < TOL, name


def test_slstm_scan_carries_state_and_writes_in_place():
    """Scanning T1 steps, then T2 from the returned state into the same
    tensors, equals one scan over T1 + T2."""
    tp, wx, _ = _fill_case(10)
    hs_all, final = slstm_scan(wx, tp["r"], tp["b"])
    hs1, st = slstm_scan(wx[:, :6], tp["r"], tp["b"])
    st = tuple(s.clone() for s in st)
    hs2, out = slstm_scan(wx[:, 6:], tp["r"], tp["b"], st, out_state=st)
    assert all(o is s for o, s in zip(out, st))
    torch.testing.assert_close(torch.cat([hs1, hs2], 1), hs_all, atol=1e-6,
                               rtol=1e-6)
    for got, want in zip(st, final):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    ref_hs, _ = slstm_scan_ref(wx, tp["r"], tp["b"])
    assert torch.equal(ref_hs, hs_all)          # the CPU route is the ref


def test_slstm_apply_matches_jax():
    jcfg, cfg, jp, tp = _mixer("slstm")
    x = _x((2, 9, cfg.d_model))
    want, _ = JX.slstm_apply(jp, jnp.asarray(x), jcfg)
    got, cache = TX.slstm_apply(tp, _t(x), cfg)
    assert cache is None
    _close(got, want)
    # one decode step from a non-trivial cache, written in place
    jc = JM._fill_slstm(jp, jnp.asarray(x), jcfg,
                        JX.init_slstm_cache(2, jcfg, jnp.float32))
    tc = caches_from_numpy(_np(jc), "cpu")
    xt = _x((2, 1, cfg.d_model), 9)
    want, jc = JX.slstm_apply(jp, jnp.asarray(xt), jcfg, cache=jc)
    got, same = TX.slstm_apply(tp, _t(xt), cfg, cache=tc)
    assert same is tc
    _close(got, want)
    for name in "hcnm":
        _close(tc[name], jc[name])


def test_slstm_scan_equals_step():
    """Twin of tests/test_layers_equivalence.py on the port alone."""
    _, cfg, _, p = _mixer("slstm")
    x = _t(_x((2, 9, cfg.d_model)))
    y_scan, _ = TX.slstm_apply(p, x, cfg)
    cache = TX.init_slstm_cache(2, cfg, torch.device("cpu"))
    outs = [TX.slstm_apply(p, x[:, t:t + 1], cfg, cache=cache)[0]
            for t in range(9)]
    torch.testing.assert_close(y_scan, torch.cat(outs, 1), atol=2e-5,
                               rtol=2e-4)


# --------------------------------------------------------------------------- #
# Model                                                                       #
# --------------------------------------------------------------------------- #


def _model_pair(repeats=1):
    jcfg, cfg = _cfgs()
    if repeats != 1:
        stages = (StageDef(jcfg.stages[0].pattern, repeats),)
        jcfg = replace(jcfg, n_layers=2 * repeats, stages=stages)
        cfg = replace(cfg, n_layers=2 * repeats, stages=stages)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(_np(jp), "cpu")


def test_two_superblock_logits_match_jax():
    """Two repeats of (mLSTM, sLSTM) with a ragged 19-token prompt:
    forward, prefill and two decode steps against the JAX model."""
    jcfg, cfg, jp, tp = _model_pair(repeats=2)
    t = 19
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, t + 2)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    jfull, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    jlog, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :t])},
                          cache_len=32)
    with torch.inference_mode():
        full, _ = M.forward(tp, cfg, {"tokens": tt})
        log, tc = M.prefill(tp, cfg, {"tokens": tt[:, :t]}, 32)
        assert _err(full, jfull) < LOGIT_TOL
        assert _err(log, jlog) < LOGIT_TOL
        for i in range(2):
            jlog, jc = JM.decode_step(jp, jcfg, jc,
                                      jnp.asarray(toks[:, t + i:t + i + 1]),
                                      jnp.int32(t + i))
            log, tc = M.decode_step(tp, cfg, tc, tt[:, t + i:t + i + 1],
                                    t + i)
            assert _err(log, jlog) < LOGIT_TOL
            assert _err(log[:, 0], jfull[:, t + i]) < LOGIT_TOL


@pytest.mark.parametrize("t", [3, 12])
def test_prefill_caches_match_jax(t):
    """conv tail, c, n, m of the mLSTM and h, c, n, m of the sLSTM; t=3
    exactly fills the conv's K-1 = 3 window, t=12 overfills it."""
    jcfg, cfg, jp, tp = _model_pair()
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, t)).astype(np.int32)
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=16)
    with torch.inference_mode():
        _, tc = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks).long()},
                          16)
    want = caches_from_numpy(_np(jc), "cpu")
    for layer, names in (("p0", ("conv", "c", "n", "m")),
                         ("p1", ("h", "c", "n", "m"))):
        for name in names:
            got = tc["dec0"][layer]["self"][name]
            ref = want["dec0"][layer]["self"][name]
            assert got.dtype == ref.dtype, (layer, name)
            assert _err(got, ref.numpy()) < TOL, (layer, name)


def test_prefill_with_short_prompt_pads_conv_tail():
    jcfg, cfg, jp, tp = _model_pair()
    toks = np.array([[5, 7]], dtype=np.int32)
    _, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cache_len=8)
    with torch.inference_mode():
        _, tc = M.prefill(tp, cfg, {"tokens": torch.from_numpy(toks).long()},
                          8)
    got = tc["dec0"]["p0"]["self"]["conv"]
    assert float(got[:, :, 0].abs().max()) == 0.0     # [layers, B, K-1, di]
    assert _err(got, np.asarray(jc["dec0"]["p0"]["self"]["conv"])) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    """Same keys, shapes and dtypes leaf for leaf, with the gate
    projections and biases in f32 whatever the param dtype."""
    jcfg, cfg = _cfgs()
    jcfg, cfg = (replace(c, param_dtype=dtype) for c in (jcfg, cfg))
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
    mix = tp["dec0"]["p0"]["mixer"]
    assert mix["w_i"].dtype == torch.float32
    assert float(mix["b_f"][0, 0]) == 3.0
    assert float(tp["dec0"]["p1"]["mixer"]["b"][0, 1, 0, 0]) == 3.0
