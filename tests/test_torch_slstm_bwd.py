"""The sLSTM scan's backward in the port: its plain version
(``slstm_scan_bwd_ref``, the oracle of the CUDA backward kernel) against
torch autograd of the plain forward and against ``jax.vjp`` of the JAX
package's scan, and ``SLSTMScanFn`` on the CPU.  The kernel itself runs
only on the card (``chip_smoke.py``).

Inputs are made with numpy from a seed, at the scales ``chip_smoke.py``
uses (wx 0.5 N(0, 1), R dh^-1/2 N(0, 1), the forget bias + 3).
Tolerances, each relative to the gradient's largest magnitude: 1e-5 in
f32 (the same f32 arithmetic summed in another order over at most 37
steps), 2e-2 in bf16 (the repo's bf16 kernel tolerance).
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.slstm_scan.ref import slstm_scan_ref as jax_slstm_scan_ref
from repro.models.layers import xlstm as JX
from repro_torch.kernels.slstm_scan import (SLSTMScanFn, ops, slstm_scan,
                                            slstm_scan_bwd,
                                            slstm_scan_bwd_ref,
                                            slstm_scan_ref,
                                            slstm_scan_saving,
                                            slstm_scan_saving_ref)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SHAPES = list(itertools.product([1, 2], [1, 5, 37], [1, 2], [8, 48]))
MODES = ["zero state", "given state", "given state, final-state grads"]


def _inputs(b, t, h, dh, seed=0):
    rng = np.random.default_rng(seed)
    wx = (0.5 * rng.standard_normal((b, t, 4, h, dh))).astype(np.float32)
    r = (dh ** -0.5 * rng.standard_normal((4, h, dh, dh))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((4, h, dh))).astype(np.float32)
    bias[1] += 3.0
    dhs = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    state = (0.5 * rng.standard_normal((b, h, dh)),       # h
             rng.standard_normal((b, h, dh)),             # c
             1.0 + rng.random((b, h, dh)),                # n >= 1
             rng.uniform(-1.0, 1.0, (b, h, dh)))          # m
    d_state = tuple(rng.standard_normal((b, h, dh)) for _ in range(4))
    f32 = lambda xs: tuple(x.astype(np.float32) for x in xs)  # noqa: E731
    return wx, r, bias, dhs, f32(state), f32(d_state)


def _t(*xs, requires_grad=False):
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 .requires_grad_(requires_grad) for x in xs)


def _rel(got, want) -> float:
    got, want = got.detach().float(), torch.as_tensor(np.array(
        want, dtype=np.float32)) if not torch.is_tensor(want) else \
        want.detach().float()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


def _autograd(wx, r, b, state, dhs, d_state):
    """Gradients of sum(hs * dhs) + sum(final * d_state) by autograd of the
    plain forward."""
    leaves = [wx, r, b, *(state or ())]
    hs, final = slstm_scan_ref(wx, r, b, state)
    loss = (hs * dhs).sum()
    if d_state is not None:
        loss = loss + sum((f * d).sum() for f, d in zip(final, d_state))
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,t,h,dh", SHAPES)
def test_bwd_ref_matches_autograd_of_the_plain_forward(b, t, h, dh, mode):
    wx, r, bias, dhs, state, d_state = _inputs(b, t, h, dh)
    wx, r, bias, dhs = _t(wx, r, bias, dhs)
    state = _t(*state) if mode != "zero state" else None
    d_state = _t(*d_state) if mode.endswith("grads") else None
    hs, _, saved = slstm_scan_saving_ref(wx, r, bias, state)
    dwx, dr, db, d0 = slstm_scan_bwd_ref(r, bias, state, hs, saved, dhs,
                                         d_state)
    want = _autograd(*_t(*(x.numpy() for x in (wx, r, bias)),
                         requires_grad=True),
                     _t(*(s.numpy() for s in state), requires_grad=True)
                     if state is not None else None, dhs, d_state)
    got = (dwx, dr, db, *(d0 if state is not None else ()))
    assert len(got) == len(want)
    for name, g, w in zip(("dwx", "dR", "db", "dh0", "dc0", "dn0", "dm0"),
                          got, want):
        assert _rel(g, w) < TOL[torch.float32], name


def test_bwd_ref_in_bf16_returns_input_dtypes():
    """wx and R in bf16: dwx and dR come back in bf16, db in the bias's
    f32, each within the bf16 tolerance of autograd of the plain
    forward."""
    wx, r, bias, dhs, _, _ = _inputs(2, 5, 2, 8)
    wx, r = (x.to(torch.bfloat16) for x in _t(wx, r))
    bias, dhs = _t(bias, dhs)
    hs, _, saved = slstm_scan_saving_ref(wx, r, bias)
    dwx, dr, db, _ = slstm_scan_bwd_ref(r, bias, None, hs, saved, dhs,
                                        wx_dtype=wx.dtype)
    assert (dwx.dtype, dr.dtype, db.dtype) == (torch.bfloat16,) * 2 + \
        (torch.float32,)
    want = _autograd(wx.detach().requires_grad_(True),
                     r.detach().requires_grad_(True),
                     bias.detach().requires_grad_(True), None, dhs, None)
    for g, w in zip((dwx, dr, db), want):
        assert _rel(g, w) < TOL[torch.bfloat16]


def test_saving_forward_returns_what_the_scan_runs():
    """hs and the final state are the scan's own; the saved c, n, m at the
    last step are the final state, and pre is wx + h_{t-1} R + b."""
    wx, r, bias, _, state, _ = _inputs(2, 5, 2, 8)
    wx, r, bias = _t(wx, r, bias)
    state = _t(*state)
    hs, final, (pre, cs, ns, ms) = slstm_scan_saving_ref(wx, r, bias, state)
    want_hs, want_final = slstm_scan_ref(wx, r, bias, state)
    assert torch.equal(hs, want_hs)
    for got, want in zip(final, want_final):
        assert torch.equal(got, want)
    for saved, fin in zip((cs, ns, ms), final[1:]):
        assert torch.equal(saved[:, -1], fin)
    h_prev = torch.cat([state[0][:, None], hs[:, :-1]], 1)
    rec = torch.einsum("bthk,ghkj->btghj", h_prev, r)
    torch.testing.assert_close(pre, wx + rec + bias, atol=1e-6, rtol=1e-6)


def _jax_vjp(fn, wx, r, bias, dhs):
    _, vjp = jax.vjp(fn, jnp.asarray(wx), jnp.asarray(r), jnp.asarray(bias))
    return vjp(jnp.asarray(dhs))


def _scan_of_step(wx, r, b):
    """lax.scan over the model's own ``_slstm_step`` from the zero state."""
    bsz, _, _, h, dh = wx.shape
    state = (jnp.zeros((bsz, h, dh)), jnp.zeros((bsz, h, dh)),
             jnp.ones((bsz, h, dh)), jnp.zeros((bsz, h, dh)))

    def step(state, wx_t):
        new = JX._slstm_step({"r": r, "b": b}, state, wx_t)
        return new, new[0]

    return jax.lax.scan(step, state, wx.swapaxes(0, 1))[1].swapaxes(0, 1)


@pytest.mark.parametrize("jax_fn", [jax_slstm_scan_ref, _scan_of_step],
                         ids=["kernel_ref", "model_step"])
@pytest.mark.parametrize("b,t,h,dh", [(1, 1, 1, 8), (2, 5, 2, 8),
                                      (1, 37, 2, 48), (2, 37, 1, 48)])
def test_bwd_ref_matches_jax_vjp(b, t, h, dh, jax_fn):
    """f32 from the zero state: jax.vjp of the JAX package's scan oracle
    (src/repro/kernels/slstm_scan/ref.py) and of lax.scan over the model's
    ``_slstm_step``, the gradient its train step takes."""
    wx, r, bias, dhs, _, _ = _inputs(b, t, h, dh, seed=3)
    want = _jax_vjp(jax_fn, wx, r, bias, dhs)
    twx, tr, tb, tdhs = _t(wx, r, bias, dhs)
    hs, _, saved = slstm_scan_saving_ref(twx, tr, tb)
    got = slstm_scan_bwd_ref(tr, tb, None, hs, saved, tdhs)[:3]
    for name, g, w in zip(("dwx", "dR", "db"), got, want, strict=True):
        assert _rel(g, np.asarray(w)) < TOL[torch.float32], name


@pytest.mark.parametrize("mode", MODES)
def test_slstm_scan_fn_on_the_cpu(mode):
    """Inputs that require grad go through ``SLSTMScanFn``: the output
    carries its grad_fn, and the gradients (of hs and, where given, of the
    final state) equal autograd of the plain forward."""
    wx, r, bias, dhs, state, d_state = _inputs(2, 5, 2, 8, seed=5)
    leaves = _t(wx, r, bias, requires_grad=True)
    st = _t(*state, requires_grad=True) if mode != "zero state" else None
    dhs = torch.from_numpy(dhs)
    d_state = _t(*d_state) if mode.endswith("grads") else None
    hs, final = slstm_scan(*leaves, st)
    assert type(hs.grad_fn).__name__ == "SLSTMScanFnBackward"
    loss = (hs * dhs).sum()
    if d_state is not None:
        loss = loss + sum((f * d).sum() for f, d in zip(final, d_state))
    got = torch.autograd.grad(loss, [*leaves, *(st or ())])
    want = _autograd(*_t(wx, r, bias, requires_grad=True),
                     _t(*state, requires_grad=True) if st is not None
                     else None, dhs, d_state)
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) < TOL[torch.float32]


def test_slstm_scan_fn_not_entered_without_grad(monkeypatch):
    calls = []
    monkeypatch.setattr(ops.SLSTMScanFn, "apply",
                        lambda *a: calls.append(a) or ("spy",) * 5)
    wx, r, bias, _, _, _ = _inputs(1, 3, 1, 8)
    leaves = _t(wx, r, bias, requires_grad=True)
    with torch.no_grad():
        hs, _ = slstm_scan(*leaves)
    assert hs.grad_fn is None and not calls
    hs, _ = slstm_scan(*_t(wx, r, bias))        # nothing requires grad
    assert hs.grad_fn is None and not calls
    slstm_scan(*leaves)
    assert len(calls) == 1


def test_out_state_under_grad_raises():
    wx, r, bias, _, state, _ = _inputs(1, 3, 1, 8)
    st = _t(*state)
    with pytest.raises(RuntimeError, match="out_state"):
        slstm_scan(*_t(wx, r, bias, requires_grad=True), st, out_state=st)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    wx, r, bias, dhs, state, d_state = _inputs(1, 5, 2, 8)
    wx, r, bias, dhs = _t(wx, r, bias, dhs)
    state, d_state = _t(*state), _t(*d_state)
    hs, _, saved = slstm_scan_saving_ref(wx, r, bias, state)
    got = slstm_scan_bwd(r, bias, state, hs, saved, dhs, d_state)
    want = slstm_scan_bwd_ref(r, bias, state, hs, saved, dhs, d_state)
    for g, w in zip((*got[:3], *got[3]), (*want[:3], *want[3])):
        assert torch.equal(g, w)
    saving = slstm_scan_saving(wx, r, bias, state)
    ref = slstm_scan_saving_ref(wx, r, bias, state)
    for g, w in zip((saving[0], *saving[1], *saving[2]),
                    (ref[0], *ref[1], *ref[2])):
        assert torch.equal(g, w)
    assert slstm_scan_bwd.launches == 0 and slstm_scan.launches == 0
    assert SLSTMScanFn is ops.SLSTMScanFn
