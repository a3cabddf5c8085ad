"""The flash kernel's backward on the CPU: its plain version
(``flash_attention_bwd_ref``) against ``torch.autograd`` of the plain
forward and against ``jax.vjp`` of the JAX model's attention
(``_gqa_scores_to_out``); ``FlashAttentionFn``'s plumbing; the backward's
plan (``plan_flash_bwd``) against the kernel's tables; and an emulation,
in float64, of the kernel's three passes (row statistics, dK/dV, dQ) with
its tile sizes and tile-skip rule, held against the plain version.  The
kernel itself runs only on the card (``chip_smoke.py``).

Tolerances: the plain backward computes in f32; against autograd of the
plain forward (f32, other order) and JAX (f32) each gradient within 2e-5
of its largest magnitude; the float64 emulation within 1e-5 of it.
"""
from __future__ import annotations

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models.layers.attention import _gqa_scores_to_out, causal_mask
from repro_torch.kernels.flash_attention import FlashAttentionFn, \
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, \
    flash_attention_ref, ops

KERNEL_SRC = Path(ops.__file__).parent / "csrc" / "flash_attention_bwd.cu"
TOL = 2e-5
EMU_TOL = 1e-5
MASKS = {"causal": (True, 0), "window": (True, 3), "unmasked": (False, 0)}
HEAD_DIMS = {"48": (48, None), "64": (64, None), "96": (96, None),
             "192-v-padded": (192, 128)}


def _case(t, s, h, kv, d, v_dim=None, offset=0, perm=False, seed=0,
          dtype=torch.float32):
    """q, k, v, positions, the plain forward's output and an upstream
    gradient; with ``v_dim`` V's and dO's columns from v_dim on are zero
    (MLA's V padded to the query/key width, its output sliced back)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((2, t, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, s, kv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, s, kv, d)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((2, t, h, d)).astype(np.float32))
    if v_dim is not None:
        v[..., v_dim:] = 0
        do[..., v_dim:] = 0
    qp = torch.arange(t, dtype=torch.int32) + offset
    kp = torch.arange(s, dtype=torch.int32) + offset
    if perm:
        kp = kp[torch.from_numpy(rng.permutation(s))]
    return [x.to(dtype) for x in (q, k, v)] + [qp, kp, do.to(dtype)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _autograd(q, k, v, qp, kp, do, causal, window):
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention_ref(q, k, v, qp, kp, causal=causal, window=window)
    return out.detach(), torch.autograd.grad(out, (q, k, v), do)


def _jax_vjp(q, k, v, qp, kp, do, causal, window):
    t, s = qp.shape[0], kp.shape[0]
    if causal:
        mask = causal_mask(jnp.asarray(qp.numpy()), jnp.asarray(kp.numpy()),
                           window)[None, None]
    else:
        mask = jnp.ones((1, 1, t, s), bool)
    _, vjp = jax.vjp(lambda a, b, c: _gqa_scores_to_out(a, b, c, mask),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    return vjp(jnp.asarray(do.numpy()))


@pytest.mark.parametrize("dk", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("mask", MASKS)
def test_bwd_ref_matches_autograd(mask, group, dk):
    causal, window = MASKS[mask]
    d, v_dim = HEAD_DIMS[dk]
    q, k, v, qp, kp, do = _case(9, 9, 2 * group, 2, d, v_dim)
    out, want = _autograd(q, k, v, qp, kp, do, causal, window)
    got = flash_attention_bwd_ref(q, k, v, qp, kp, out, do, causal=causal,
                                  window=window)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) < TOL
    if v_dim is not None:                   # padded columns: no gradient
        assert not got[2][..., v_dim:].any()


@pytest.mark.parametrize("dk", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("mask", MASKS)
def test_bwd_ref_matches_jax_vjp(mask, group, dk):
    causal, window = MASKS[mask]
    d, v_dim = HEAD_DIMS[dk]
    s = 9 if causal else 5                   # unmasked: other keys (cross)
    q, k, v, qp, kp, do = _case(9, s, 2 * group, 2, d, v_dim, seed=1)
    out = flash_attention_ref(q, k, v, qp, kp, causal=causal, window=window)
    got = flash_attention_bwd_ref(q, k, v, qp, kp, out, do, causal=causal,
                                  window=window)
    want = _jax_vjp(q, k, v, qp, kp, do, causal, window)
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) < TOL


@pytest.mark.parametrize("case", ["offset", "shuffled", "masked-rows"])
def test_bwd_ref_positions(case):
    """Positions from 100; keys in a random order of positions; keys at
    positions 3.. so the first three queries see no key (their output is
    0, so every gradient through them is 0)."""
    kw = {"offset": dict(offset=100), "shuffled": dict(perm=True),
          "masked-rows": {}}[case]
    q, k, v, qp, kp, do = _case(11, 11, 14, 2, 64, seed=2, **kw)
    if case == "masked-rows":
        kp = kp + 3
    out, want = _autograd(q, k, v, qp, kp, do, True, 0)
    got = flash_attention_bwd_ref(q, k, v, qp, kp, out, do)
    jax_want = _jax_vjp(q, k, v, qp, kp, do, True, 0)
    for g, w, j in zip(got, want, jax_want, strict=True):
        assert _rel(g, w) < TOL and _rel(g, j) < TOL
    if case == "masked-rows":
        assert not out[:, :3].any() and not got[0][:, :3].any()
        # the last three keys (positions 11..13) serve no query
        assert not got[1][:, -3:].any() and not got[2][:, -3:].any()


def test_bwd_ref_bf16_outputs_in_input_dtype():
    q, k, v, qp, kp, do = _case(9, 9, 4, 2, 64, dtype=torch.bfloat16)
    out = flash_attention_ref(q, k, v, qp, kp)
    got = flash_attention_bwd_ref(q, k, v, qp, kp, out, do)
    assert all(g.dtype == torch.bfloat16 for g in got)
    f32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v)), qp, kp,
                                  out.float(), do.float())
    for g, w in zip(got, f32):
        assert _rel(g.float(), w) < 2 ** -8


# --------------------------------------------------------------------------- #
# FlashAttentionFn                                                            #
# --------------------------------------------------------------------------- #


def test_flash_attention_fn_on_the_cpu():
    """With an input that requires grad, ``flash_attention`` runs through
    the Function, whose CPU backward is the plain backward; without one,
    or under no_grad, it saves nothing and builds no graph."""
    q, k, v, qp, kp, do = _case(10, 10, 14, 2, 64, seed=3)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qg, kg, vg, qp, kp, causal=True, window=4)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    _, want = _autograd(q, k, v, qp, kp, do, True, 4)
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) < TOL
    # only k requires grad: the others get none, k's matches
    kg = k.clone().requires_grad_(True)
    out = flash_attention(q, kg, v, qp, kp)
    dk, = torch.autograd.grad(out, (kg,), do)
    _, want = _autograd(q, k, v, qp, kp, do, True, 0)
    assert _rel(dk, want[1]) < TOL
    assert flash_attention(q, k, v, qp, kp).grad_fn is None
    with torch.no_grad():
        assert flash_attention(qg, kg, vg, qp, kp).grad_fn is None
    apply = FlashAttentionFn.apply(qg, kg, vg, qp, kp, True, 0)
    torch.testing.assert_close(apply, flash_attention_ref(q, k, v, qp, kp))


def test_flash_attention_bwd_cpu_takes_the_plain_version():
    q, k, v, qp, kp, do = _case(7, 7, 4, 2, 32, seed=4)
    out = flash_attention_ref(q, k, v, qp, kp)
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, qp, kp, out, do)
    want = flash_attention_bwd_ref(q, k, v, qp, kp, out, do)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    assert flash_attention_bwd.launches == launches


# --------------------------------------------------------------------------- #
# The backward's plan                                                         #
# --------------------------------------------------------------------------- #


def _c_array(name: str) -> list[int]:
    body = re.search(rf"constexpr int {name}\[[^=]*= (\{{.*?\}});",
                     KERNEL_SRC.read_text(), re.S).group(1)
    return [int(x) for x in re.findall(r"-?\d+", body)]


def _c_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         KERNEL_SRC.read_text()).group(1))


def test_plan_tables_are_the_kernels():
    assert _c_array("kDMax") == list(ops.D_CLASSES)
    for name, table, col in (("kStatsRows", ops.BWD_STATS, 0),
                             ("kStatsKeys", ops.BWD_STATS, 1),
                             ("kKeyWarps", ops.BWD_KEYS, 0),
                             ("kKeyParts", ops.BWD_KEYS, 1),
                             ("kKeyStep", ops.BWD_KEYS, 2),
                             ("kRowWarps", ops.BWD_ROWS, 0),
                             ("kRowParts", ops.BWD_ROWS, 1),
                             ("kRowKeys", ops.BWD_ROWS, 2)):
        assert _c_array(name) == [row[col] for dtype in (torch.float32,
                                                          torch.bfloat16)
                                  for row in table[dtype]], name
    assert _c_const("kStages") == ops.BWD_STAGES
    assert _c_const("kMaxSmem") == ops.SMEM_LIMIT
    assert _c_const("kMaxHeadDim") == ops.MAX_HEAD_DIM
    assert re.search(r"\bmma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16"
                     r"\.bf16\.f32\b", KERNEL_SRC.read_text())
    # deterministic: no atomics, no reductions to memory (in the code)
    code = re.sub(r"//.*", "", KERNEL_SRC.read_text())
    assert not re.search(r"atomic|\bred\.", code)


@pytest.mark.parametrize("d,smem", [
    (64, ((69296, 167216, 167216), (27952, 75824, 75312))),
    (128, ((130736, 173744, 173744), (43696, 103472, 140848))),
    (192, ((228208, 219696, 219568), (42352, 169008, 204080)))])
def test_plan_smem_by_class(d, smem):
    """Each class's shared memory, by dtype (the kernel's launch refuses
    any other sum)."""
    for dtype, want in zip((torch.float32, torch.bfloat16), smem):
        plan = ops.plan_flash_bwd(1, 16, 16, 14, 2, d, dtype)
        assert plan.smem_bytes == want


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 3), t=st.integers(1, 5000), s=st.integers(1, 5000),
       kv=st.integers(1, 16), group=st.integers(1, 8),
       d=st.integers(1, 256), bf16=st.booleans())
def test_plan_flash_bwd_covers_every_row_and_key(b, t, s, kv, group, d,
                                                 bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    plan = ops.plan_flash_bwd(b, t, s, group * kv, kv, d, dtype)
    assert d <= plan.d_class and plan.d_class in ops.D_CLASSES
    m = group * t
    assert plan.stats_grid == (kv * b, math.ceil(m / plan.stats_rows), 1)
    assert plan.row_grid == (kv * b, math.ceil(m / plan.rows), 1)
    assert plan.key_grid == (kv * b, math.ceil(s / plan.keys) * plan.n_split,
                             1)
    # the chunks cover the rows, none empty, each whole steps
    assert plan.chunk % plan.step_rows == 0
    assert (plan.n_split - 1) * plan.chunk < m <= plan.n_split * plan.chunk
    assert 1 <= plan.n_split <= ops.MAX_SPLIT or plan.chunk == \
        plan.step_rows
    assert max(plan.smem_bytes) <= ops.SMEM_LIMIT
    assert all(x % 16 == 0 for x in (plan.stats_rows, plan.stats_keys,
                                     plan.keys, plan.step_rows, plan.rows,
                                     plan.tile_keys))
    assert plan.keys * plan.key_parts == 16 * plan.threads[1] // 32
    assert plan.rows * plan.row_parts == 16 * plan.threads[2] // 32
    assert plan.threads[0] == 2 * plan.stats_rows
    dp, pl = -(-d // 16) * 16, 3 if dtype == torch.float32 else 1
    assert plan.plane_values == 2 * b * kv * pl * (m + s) * dp
    assert plan.partial_values == (2 * plan.n_split * b * s * kv * d
                                   if plan.n_split > 1 else 0)


def test_plan_flash_bwd_splits_rows_to_fill_the_card():
    """qwen2's KV = 2 heads give 64 dK/dV CTAs at T = 4096: the rows are
    cut into 7 chunks of one head each; deepseek-7b's 32 heads need no
    cut."""
    plan = ops.plan_flash_bwd(1, 4096, 4096, 14, 2, 64, torch.float32)
    assert (plan.n_split, plan.chunk, plan.key_grid) == (7, 4096, (2, 224, 1))
    plan = ops.plan_flash_bwd(1, 1024, 1024, 32, 32, 128, torch.float32)
    assert plan.n_split == 1 and plan.partial_values == 0


def test_plan_flash_bwd_halves_stats_rows_for_long_keys():
    """At the 256 class in f32 the statistics' 128 rows leave room for a
    visit list of some 850 K tiles; beyond it the plan takes the kernel's
    64-row instance, whose sum the launch accepts as well."""
    short = ops.plan_flash_bwd(1, 1024, 1024, 4, 4, 192, torch.float32)
    long = ops.plan_flash_bwd(1, 20000, 20000, 4, 4, 192, torch.float32)
    assert (short.stats_rows, long.stats_rows) == (128, 64)
    assert long.stats_grid == (4, math.ceil(20000 / 64), 1)
    assert long.smem_bytes[0] == ops.bwd_smem_bytes(
        torch.float32, 256, math.ceil(20000 / 16), 1, 1, 64)[0]
    assert max(long.smem_bytes) <= ops.SMEM_LIMIT


def test_plan_flash_bwd_refuses():
    with pytest.raises(ValueError, match="head dim"):
        ops.plan_flash_bwd(1, 4, 4, 2, 2, 257, torch.float32)
    with pytest.raises(ValueError, match="no backward plan"):
        ops.plan_flash_bwd(1, 4, 4, 3, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        ops.plan_flash_bwd(1, 4, 4, 2, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="over 65535"):
        ops.plan_flash_bwd(1, 1 << 20, 4, 8, 1, 64, torch.float32)


# --------------------------------------------------------------------------- #
# The kernel's passes, emulated                                               #
# --------------------------------------------------------------------------- #


def _pairs(qps, kps, causal, window):
    if not causal:
        return np.ones((len(qps), len(kps)), bool)
    ok = kps[None, :] <= qps[:, None]
    if window > 0:
        ok &= kps[None, :] > qps[:, None] - window
    return ok


def _skip(qps, kps, whole, causal, window) -> bool:
    return ops.tile_rule(int(qps.min()), int(qps.max()), int(kps.min()),
                         int(kps.max()), whole, causal, window) == 0


def _emulate(q, k, v, qp, kp, out, do, causal, window,
             dtype=torch.float32):
    """The three launches in float64, CTA by CTA, with the plan's tiles
    and order: (a) per CTA of ``stats_rows`` fold rows the log-sum-exp of
    its valid scores in the log2 domain (an online max and sum over its
    visit list of ``stats_keys``-key tiles) and delta; (b) per CTA of
    ``keys`` keys and row chunk, dK and dV over the chunk's visited steps
    of ``step_rows`` rows, the chunks' partials then summed in chunk order
    (by (c) in the kernel); (c) per CTA of ``rows`` rows, dQ over its
    visited ``tile_keys``-key tiles.  Tiles the rule skips are never looked
    at; every valid pair must lie in a visited tile of (b)."""
    q, k, v, out, do = (x.double().numpy() for x in (q, k, v, out, do))
    qp, kp = qp.numpy(), kp.numpy()
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    m_rows = g * t
    plan = ops.plan_flash_bwd(b, t, s, h, kv, d, dtype)
    sl2 = math.log2(math.e) / math.sqrt(d)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    seen = 0

    def visits(r0, r1, n0, n1, tile, over_keys):
        """The visit list of a CTA: over_keys, its rows [r0, r1) against
        the K tiles of [n0, n1); else its keys [n0, n1) against the row
        steps of [r0, r1)."""
        if over_keys:
            return [(r0, r1, j, min(j + tile, n1)) for j in range(n0, n1, tile)
                    if not _skip(qps[r0:r1], kp[j:j + tile], j + tile <= s,
                                 causal, window)]
        return [(i, min(i + tile, r1), n0, n1) for i in range(r0, r1, tile)
                if not _skip(qps[i:i + tile], kp[n0:n1], n0 + plan.keys <= s,
                             causal, window)]

    for bz in range(b):
        for kvh in range(kv):
            rows = np.arange(m_rows)
            heads, toks = kvh * g + rows // t, rows % t
            qf, dof = q[bz, toks, heads], do[bz, toks, heads]
            delta = (dof * out[bz, toks, heads]).sum(-1)
            qps = qp[toks]
            kf, vf = k[bz, :, kvh], v[bz, :, kvh]
            lse = np.full(m_rows, np.inf)
            for r0 in range(0, m_rows, plan.stats_rows):             # (a)
                r1 = min(r0 + plan.stats_rows, m_rows)
                mx, l = np.full(r1 - r0, -np.inf), np.zeros(r1 - r0)
                for _, _, n0, n1 in visits(r0, r1, 0, s, plan.stats_keys,
                                           True):
                    ok = _pairs(qps[r0:r1], kp[n0:n1], causal, window)
                    x = np.where(ok, qf[r0:r1] @ kf[n0:n1].T * sl2, -np.inf)
                    new = np.maximum(mx, x.max(1))
                    top = np.where(new > -np.inf, new, 0)  # -inf - -inf: 0
                    l = l * np.exp2(mx - top) + np.exp2(x - top[:, None]
                                                        ).sum(1)
                    mx = new
                lse[r0:r1] = np.where(l > 0, mx + np.log2(np.maximum(
                    l, 1e-300)), np.inf)

            def tile(r0, r1, n0, n1):
                ok = _pairs(qps[r0:r1], kp[n0:n1], causal, window)
                p = np.where(ok, np.exp2(qf[r0:r1] @ kf[n0:n1].T * sl2
                                         - lse[r0:r1, None]), 0)
                return ok, p, p * (dof[r0:r1] @ vf[n0:n1].T
                                   - delta[r0:r1, None])

            for n0 in range(0, s, plan.keys):                        # (b)
                n1 = min(n0 + plan.keys, s)
                parts = []
                for c0 in range(0, plan.n_split * plan.chunk, plan.chunk):
                    pk = np.zeros((n1 - n0, d))
                    pv = np.zeros((n1 - n0, d))
                    for r0, r1, _, _ in visits(
                            c0, min(c0 + plan.chunk, m_rows), n0, n1,
                            plan.step_rows, False):
                        ok, p, ds = tile(r0, r1, n0, n1)
                        seen += int(ok.sum())
                        pv += p.T @ dof[r0:r1]
                        pk += ds.T @ qf[r0:r1]
                    parts.append((pk, pv))
                for pk, pv in parts:                      # in chunk order
                    dk[bz, n0:n1, kvh] += pk / math.sqrt(d)
                    dv[bz, n0:n1, kvh] += pv
            for r0 in range(0, m_rows, plan.rows):                   # (c)
                r1 = min(r0 + plan.rows, m_rows)
                for _, _, n0, n1 in visits(r0, r1, 0, s, plan.tile_keys,
                                           True):
                    _, _, ds = tile(r0, r1, n0, n1)
                    dq[bz, toks[r0:r1], heads[r0:r1]] += \
                        ds @ kf[n0:n1] / math.sqrt(d)
    valid = b * kv * g * int(_pairs(qp, kp, causal, window).sum())
    assert seen == valid                    # no valid pair was skipped
    return dq, dk, dv


@pytest.mark.parametrize("case", [
    dict(t=37, h=14, kv=2, d=64), dict(t=37, h=14, kv=2, d=64, window=5),
    dict(t=1, s=70, h=16, kv=16, d=64, causal=False),
    dict(t=70, h=4, kv=2, d=48, perm=True),
    dict(t=20, h=4, kv=1, d=96, offset=100),
    dict(t=40, h=4, kv=4, d=192, v_dim=128),
    dict(t=130, h=2, kv=1, d=32, masked_rows=5)],
    ids=["causal-G7", "window", "cross-T1", "shuffled-D48", "offset-D96",
         "mla-D192", "masked-rows"])
def test_emulated_kernel_passes_match_the_plain_backward(case):
    case = dict(case)
    causal = case.pop("causal", True)
    window = case.pop("window", 0)
    shift = case.pop("masked_rows", 0)
    t = case.pop("t")
    q, k, v, qp, kp, do = _case(t, case.pop("s", t), **case, seed=5)
    kp = kp + shift
    out = flash_attention_ref(q, k, v, qp, kp, causal=causal, window=window)
    want = flash_attention_bwd_ref(q, k, v, qp, kp, out, do, causal=causal,
                                   window=window)
    for dtype in (torch.float32, torch.bfloat16):     # both plans' tiles
        got = _emulate(q, k, v, qp, kp, out, do, causal, window, dtype)
        for g, w in zip(got, want, strict=True):
            assert _rel(g, w) < EMU_TOL


# --------------------------------------------------------------------------- #
# The kernel's f32 arithmetic: three bf16 pieces, six passes a slice          #
# --------------------------------------------------------------------------- #


def _pieces(x: torch.Tensor) -> list[torch.Tensor]:
    """hi, mid, lo: bf16 values (held in f32) whose sum is x exactly."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    return [hi, mid, (x - hi - mid).to(torch.bfloat16).float()]


def _six_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel forms it from f32 operands: both split into
    three pieces, each 16-deep slice of the products summed from zero in
    f32 over the six passes ``ops.PASSES`` (small first) and added to the
    running f32 sum."""
    pa, pb = _pieces(a), _pieces(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for c in range(0, a.shape[1], 16):
        part = torch.zeros_like(acc)
        for i, j in ops.PASSES:
            part = part + pa[i][:, c:c + 16] @ pb[j][c:c + 16]
        acc = acc + part
    return acc


@pytest.mark.parametrize("case", [
    dict(t=40, d=48, causal=True, window=0),
    dict(t=33, d=64, causal=True, window=9),
    dict(t=24, d=96, causal=False, window=0)],
    ids=["causal-D48", "window-D64", "unmasked-D96"])
def test_six_pass_scheme_matches_float64(case):
    """Every product of the backward (S for the statistics and again for P,
    dP, dV = P^T dO, dK = dS^T Q, dQ = dS K) in the six-pass scheme, with P
    and dS split like the other operands, holds each gradient to float64
    within the kernel's f32 tolerance (2e-5 of its largest magnitude); a
    single bf16 pass (hi.hi) does not."""
    t, d = case["t"], case["d"]
    q, k, v, qp, kp, do = _case(t, t, 4, 2, d, seed=6)
    b, h, g = 0, 3, 2                          # one head of the second group
    qh, kh, vh, doh = q[b, :, h], k[b, :, h // g], v[b, :, h // g], \
        do[b, :, h]
    ok = torch.from_numpy(_pairs(qp.numpy(), kp.numpy(), case["causal"],
                                 case["window"]))
    sl2 = math.log2(math.e) / math.sqrt(d)

    def backward(mm):
        s2 = torch.where(ok, mm(qh, kh.T) * sl2, -torch.inf)
        lse = torch.logsumexp(s2 * math.log(2), 1) / math.log(2)
        p = torch.where(ok, torch.exp2(s2 - lse[:, None]), 0)
        out = mm(p, vh)
        ds = p * (mm(doh, vh.T) - (doh * out).sum(1, keepdim=True))
        return (mm(ds, kh) / math.sqrt(d), mm(ds.T, qh) / math.sqrt(d),
                mm(p.T, doh))

    want = backward(lambda a, c: a.double() @ c.double())
    got = backward(_six_pass)
    one = backward(lambda a, c: a.to(torch.bfloat16).float()
                   @ c.to(torch.bfloat16).float())
    for x, w, y in zip(got, want, one, strict=True):
        assert x.dtype == torch.float32
        assert _rel(x, w) < TOL
        assert _rel(y, w) > TOL
