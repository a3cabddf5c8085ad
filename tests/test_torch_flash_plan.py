"""Host-side planning of the flash attention kernel: how the wrapper folds
each GQA group into the rows of a CTA, how much shared memory a CTA takes,
and which K tiles a CTA skips.  The kernel itself runs only on the card
(``chip_smoke.py``); here its walk over the tiles is emulated in float64
and held against the plain version."""
from __future__ import annotations

import ctypes
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels.flash_attention import flash_attention_ref, ops, \
    phases

KERNEL_SRC = Path(ops.__file__).parent / "csrc" / "flash_attention.cu"
DTYPES = [torch.float32, torch.bfloat16]
HEAD_DIMS = [32, 48, 64, 128, 192]          # the repo's configs


def _c_array(name: str) -> list[int]:
    body = re.search(rf"constexpr int {name}\[[^=]*= (\{{.*?\}});",
                     KERNEL_SRC.read_text(), re.S).group(1)
    return [int(x) for x in re.findall(r"-?\d+", body)]


def _c_const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         KERNEL_SRC.read_text()).group(1))


def _covered(plan, t, h, kv, b=1):
    """Every (batch, query head, token) the plan's CTAs compute."""
    group = h // kv
    rows = []
    for bz in range(b):
        for kvh in range(kv):
            for by in range(plan.n_row_tiles):
                rows += [(bz, hh, tt)
                         for hh, tt in ops.query_rows(plan, t, group, by, kvh)]
    return rows


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 13, 16, 1024])
@pytest.mark.parametrize("group", [1, 2, 7])
def test_plan_covers_every_row_once(group, t, dtype):
    for kv, b in ((1, 1), (2, 1), (2, 2)):
        h = group * kv
        plan = ops.plan_flash(b, t, t, h, kv, 64, dtype)
        rows = _covered(plan, t, h, kv, b)
        assert sorted(rows) == [(bz, hh, tt) for bz in range(b)
                                for hh in range(h) for tt in range(t)]
        assert len(set(rows)) == len(rows)
        assert plan.rows % 16 == 0 and 16 <= plan.rows <= ops.MAX_ROWS
        assert (2 * plan.rows) % (plan.d_class // 4) == 0
        assert plan.n_row_tiles == math.ceil(group * t / plan.rows)
        assert plan.grid == (kv * b, plan.n_row_tiles, 1)
        assert plan.threads == 2 * plan.rows * plan.key_groups <= 256
        split = (plan.d_class == 64 and plan.n_key_tiles >= 2
                 and math.ceil(group * t / 64) * kv * b <= ops.SM_COUNT)
        assert plan.key_groups == (2 if split else 1)
        assert plan.rows >= 64       # its threads also copy the K/V tiles
        # no CTA is idle
        assert (plan.n_row_tiles - 1) * plan.rows < group * t


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("h,kv,d", [(14, 2, 64), (32, 32, 128)],
                         ids=["qwen2", "phi3-mini"])
def test_long_prompt_fills_the_card(h, kv, d, dtype):
    """At T=1024 the served heads still give a wave of CTAs over the 132
    SMs; the serving prompt (T=16) folds qwen2's group of 7 into 112 rows."""
    plan = ops.plan_flash(1, 1024, 1024, h, kv, d, dtype)
    assert math.prod(plan.grid) >= ops.SM_COUNT
    short = ops.plan_flash(1, 16, 16, 14, 2, 64, dtype)
    assert short.grid == (2, 2, 1) and short.rows == 64
    assert short.key_groups == 1 and plan.key_groups == 1
    # a 128-token prompt spans two K tiles on 28 CTAs: two key groups
    assert ops.plan_flash(1, 128, 128, 14, 2, 64, dtype).key_groups == 2


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plan_shared_memory_fits(d, dtype):
    for t, s in ((1, 1), (16, 16), (1024, 1024), (16, 4096), (4096, 4096)):
        for h, kv in ((14, 2), (32, 32), (4, 4)):
            plan = ops.plan_flash(1, t, s, h, kv, d, dtype)
            assert plan.smem_bytes <= ops.SMEM_LIMIT == 232448
            assert plan.d_class == min(c for c in ops.D_CLASSES if c >= d)
            assert plan.n_key_tiles == -(-s // plan.tile_keys)
            assert plan.smem_bytes == ops.smem_bytes(
                dtype, plan.d_class, plan.rows, plan.n_key_tiles,
                plan.key_groups)
            assert plan.smem_bytes % 16 == 0
            # two threads a row copy whole rows of 16-byte units
            assert (2 * plan.rows) % (plan.d_class // 4) == 0


def test_plan_depends_on_the_shapes_alone():
    """The plan is a pure function of the shapes and the dtype: the same
    shapes plan alike whatever the data, and nothing else is asked."""
    params = list(inspect.signature(ops.plan_flash).parameters)
    assert params == ["b", "t", "s", "h", "kv", "d", "dtype"]
    for dtype in DTYPES:
        a = ops.plan_flash.__wrapped__(1, 37, 37, 4, 2, 48, dtype)
        assert a == ops.plan_flash.__wrapped__(1, 37, 37, 4, 2, 48, dtype)
        assert a == ops.plan_flash(1, 37, 37, 4, 2, 48, dtype)


@pytest.mark.parametrize("args,match", [
    ((1, 4, 4, 3, 2, 64, torch.float32), "no plan"),
    ((1, 4, 4, 2, 2, 257, torch.float32), "head dim"),
    ((1, 4, 4, 2, 2, 64, torch.float16), "not supported"),
    ((1, 4, 1 << 24, 2, 2, 256, torch.float32), "shared memory"),
])
def test_plan_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        ops.plan_flash(*args)


def test_constants_match_the_kernel():
    assert _c_array("kDMax") == list(ops.D_CLASSES)
    assert _c_array("kBK") == [*ops.TILE_KEYS[torch.float32],
                               *ops.TILE_KEYS[torch.bfloat16]]
    assert _c_array("kStages") == [*ops.STAGES[torch.float32],
                                   *ops.STAGES[torch.bfloat16]]
    assert _c_const("kMaxSmem") == ops.SMEM_LIMIT
    assert _c_const("kMaxRows") == ops.MAX_ROWS
    assert _c_const("kMaxHeadDim") == ops.MAX_HEAD_DIM
    # the split passes: (2,0) (0,2) (1,1) (1,0) (0,1) (0,0), small first
    assert [(_pass(KERNEL_SRC.read_text(), "pass_a", q),
             _pass(KERNEL_SRC.read_text(), "pass_b", q))
            for q in range(6)] == list(ops.PASSES)
    assert sorted(ops.PASSES) == sorted(
        (a, b) for a in range(3) for b in range(3) if a + b <= 2)


def _pass(src: str, fn: str, q: int) -> int:
    """pass_a / pass_b at q, from its chain ``q == i ? x : ... : default``."""
    body = re.search(rf"int {fn}\(int q\) \{{\s*return (.*?);", src,
                     re.S).group(1)
    table = {int(i): int(x) for i, x in re.findall(r"q == (\d+) \? (\d+)",
                                                    body)}
    return table.get(q, int(body.rsplit(":", 1)[1]))


def test_launch_argtypes_match_the_c_entry_point():
    decl = re.search(r'extern "C" int flash_attention_launch\((.*?)\)',
                     KERNEL_SRC.read_text(), re.S).group(1)
    got = [ctypes.c_void_p if "*" in a else ctypes.c_int
           for a in decl.split(",")]
    assert got == ops.ARGTYPES


def test_phase_markers_are_in_the_kernel():
    """The phase timer (``phases.py``) patches the kernel source at fixed
    texts: each must occur exactly once, and the patched source reads the
    clock at every phase."""
    src = KERNEL_SRC.read_text()
    for plain, timed in phases.MARKERS:
        assert src.count(plain) == 1, plain
        assert "PHASE(" in timed
    timed_src = phases.instrumented_source()
    assert timed_src.count("PHASE(") == len(phases.MARKERS) + 1  # + define


def test_tile_rule_cases():
    rule = ops.tile_rule
    # causal: keys all after every query -> skipped; all before -> unmasked
    assert rule(10, 20, 21, 30, True, True, 0) == 0
    assert rule(10, 20, 0, 10, True, True, 0) == 2
    assert rule(10, 20, 0, 10, False, True, 0) == 1   # ragged: mask
    assert rule(10, 20, 15, 30, True, True, 0) == 1
    # window 5: keys <= qp_min - 5 are out of every window
    assert rule(10, 20, 0, 5, True, True, 5) == 0
    assert rule(10, 20, 0, 6, True, True, 5) == 1
    assert rule(20, 20, 16, 20, True, True, 5) == 2
    # not causal: never skipped
    assert rule(10, 20, 100, 200, True, False, 0) == 2
    assert rule(10, 20, 100, 200, False, False, 3) == 1


def _valid_pairs(q_pos, k_pos, causal, window) -> np.ndarray:
    """[T, S] pairs that flash_attention_ref leaves valid, read from its
    output: zero scores and V = I give 1/n on valid keys and 0 elsewhere."""
    t, s = len(q_pos), len(k_pos)
    q = torch.zeros((1, t, 1, s))
    k = torch.zeros((1, s, 1, s))
    v = torch.eye(s)[None, :, None, :]
    out = flash_attention_ref(q, k, v, torch.tensor(q_pos, dtype=torch.int32),
                              torch.tensor(k_pos, dtype=torch.int32),
                              causal=causal, window=window)
    return out[0, :, 0, :].numpy() > 0


def _positions(draw, n: int, kind: str, offset: int) -> list[int]:
    if kind == "sorted":
        return [offset + i for i in range(n)]
    if kind == "permuted":
        return [offset + i for i in draw(st.permutations(range(n)))]
    return draw(st.lists(st.integers(-60, 200), min_size=n, max_size=n))


@st.composite
def _cases(draw):
    t = draw(st.integers(1, 40))
    s = draw(st.sampled_from([t, draw(st.integers(1, 200))]))
    offset = draw(st.sampled_from([0, 100, -7]))
    qkind = draw(st.sampled_from(["sorted", "permuted", "random"]))
    kkind = draw(st.sampled_from(["sorted", "permuted", "random"]))
    q_pos = _positions(draw, t, qkind, offset)
    k_pos = _positions(draw, s, kkind, offset)
    causal = draw(st.booleans())
    window = draw(st.sampled_from([0, 0, 1, 4, 17]))
    group = draw(st.sampled_from([1, 2, 7]))
    dtype = draw(st.sampled_from(DTYPES))
    d = draw(st.sampled_from([32, 128, 192]))
    return q_pos, k_pos, causal, window, group, dtype, d


@settings(max_examples=300, deadline=None)
@given(_cases())
def test_skip_rule_never_skips_a_valid_pair(case):
    """Every pair the plain version's mask leaves valid lies in a tile that
    the CTA owning its row visits; every tile visited unmasked holds only
    valid pairs.  Positions may be unsorted, repeated or negative."""
    q_pos, k_pos, causal, window, group, dtype, d = case
    t, s = len(q_pos), len(k_pos)
    valid = _valid_pairs(q_pos, k_pos, causal, window)
    plan = ops.plan_flash(1, t, s, group, 1, d, dtype)
    bk = plan.tile_keys
    for by in range(plan.n_row_tiles):
        rows = ops.query_rows(plan, t, group, by, 0)
        toks = sorted({tt for _, tt in rows})
        visits = dict(ops.visit_list(plan, q_pos, k_pos, group, by, causal,
                                     window))
        for j in range(plan.n_key_tiles):
            block = valid[np.ix_(toks, range(j * bk, min(s, (j + 1) * bk)))]
            if block.any():
                assert j in visits, (by, j)
            if visits.get(j):
                assert block.all(), (by, j)


def _emulate(q, k, v, q_pos, k_pos, causal, window, dtype):
    """The kernel's walk in float64: each CTA's rows over its visit list,
    key group g taking visits g, g + key_groups, ..., pairs masked unless
    the tile is unmasked, the online softmax with the kernel's guard for
    rows with no valid key yet, then the groups' merge."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    group = h // kv
    plan = ops.plan_flash(b, t, s, h, kv, d, dtype)
    bk, ks = plan.tile_keys, plan.key_groups
    scale = d ** -0.5
    out = np.zeros((b, t, h, d))
    qp, kp = np.asarray(q_pos), np.asarray(k_pos)
    for bz in range(b):
        for kvh in range(kv):
            for by in range(plan.n_row_tiles):
                rows = ops.query_rows(plan, t, group, by, kvh)
                hs = np.array([hh for hh, _ in rows])
                ts = np.array([tt for _, tt in rows])
                qr = q[bz, ts, hs]                          # [R, D]
                visits = ops.visit_list(plan, q_pos, k_pos, group, by,
                                        causal, window)
                parts = []
                for g in range(ks):
                    m = np.full(len(rows), -np.inf)
                    l = np.zeros(len(rows))
                    acc = np.zeros((len(rows), d))
                    for j, full in visits[g::ks]:
                        keys = np.arange(j * bk, min(s, (j + 1) * bk))
                        sc = qr @ k[bz, keys, kvh].T * scale    # [R, K]
                        if not full:
                            ok = np.ones_like(sc, dtype=bool)
                            if causal:
                                ok = kp[keys][None] <= qp[ts][:, None]
                                if window > 0:
                                    ok &= (kp[keys][None]
                                           > qp[ts][:, None] - window)
                            sc = np.where(ok, sc, -np.inf)
                        m_new = np.maximum(m, sc.max(axis=1))
                        live = m_new != -np.inf      # else P = 0, sums kept
                        safe = np.where(live, m_new, 0.0)
                        alpha = np.where(live, np.exp(m - safe), 1.0)
                        p = np.exp(sc - safe[:, None]) * live[:, None]
                        acc = acc * alpha[:, None] + p @ v[bz, keys, kvh]
                        l = l * alpha + p.sum(axis=1)
                        m = m_new
                    parts.append((m, l, acc))
                m = np.max([pm for pm, _, _ in parts], axis=0)
                safe = np.where(m != -np.inf, m, 0.0)
                l = sum(pl * np.exp(pm - safe) for pm, pl, _ in parts)
                acc = sum(pa * np.exp(pm - safe)[:, None]
                          for pm, _, pa in parts)
                res = np.where(l[:, None] > 0, acc / np.where(l > 0, l, 1)
                               [:, None], 0.0)
                out[bz, ts, hs] = res
    return out


@settings(max_examples=60, deadline=None)
@given(_cases(), st.integers(0, 2**31 - 1))
def test_emulated_tile_walk_matches_the_plain_version(case, seed):
    """The kernel's algorithm (its row cut, skip rule, unmasked tiles and
    online softmax with the -inf guard), at the plan's tile widths, gives
    the plain version's output, zero rows included."""
    q_pos, k_pos, causal, window, group, dtype, _ = case
    t, s = len(q_pos), len(k_pos)
    rng = np.random.default_rng(seed)
    kv, d = 2, 16
    q = rng.standard_normal((1, t, group * kv, d)).astype(np.float32)
    k = rng.standard_normal((1, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((1, s, kv, d)).astype(np.float32)
    got = _emulate(q.astype(np.float64), k.astype(np.float64),
                   v.astype(np.float64), q_pos, k_pos, causal, window, dtype)
    want = flash_attention_ref(
        *map(torch.from_numpy, (q, k, v)),
        torch.tensor(q_pos, dtype=torch.int32),
        torch.tensor(k_pos, dtype=torch.int32), causal=causal,
        window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype,t,window,offset", [
    (torch.float32, 150, 0, 0), (torch.float32, 150, 40, 7),
    (torch.bfloat16, 300, 0, 0), (torch.bfloat16, 300, 100, -5)])
def test_emulated_key_groups_match_the_plain_version(dtype, t, window,
                                                     offset):
    """Prompts long enough for two key groups (and, with a window, skipped
    tiles on both sides of each row tile), GQA group of 7 and D=64: the
    groups' partials merge to the plain version's output."""
    rng = np.random.default_rng(t + window)
    h, kv, d = 14, 2, 64
    plan = ops.plan_flash(1, t, t, h, kv, d, dtype)
    assert plan.key_groups == 2         # both groups walk several tiles
    q = rng.standard_normal((1, t, h, d)).astype(np.float32)
    k = rng.standard_normal((1, t, kv, d)).astype(np.float32)
    v = rng.standard_normal((1, t, kv, d)).astype(np.float32)
    pos = list(range(offset, offset + t))
    got = _emulate(q.astype(np.float64), k.astype(np.float64),
                   v.astype(np.float64), pos, pos, True, window, dtype)
    want = flash_attention_ref(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(pos, dtype=torch.int32),
        torch.tensor(pos, dtype=torch.int32), window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
