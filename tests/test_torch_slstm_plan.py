"""Host-side planning of the sLSTM scan kernel: how the wrapper splits a
head's state columns over the CTAs of a cluster, and which rows of R each
CTA keeps in registers and shared memory.  The kernel itself runs only on
the card (``chip_smoke.py``)."""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.slstm_scan import ops, phases

KERNEL_SRC = Path(ops.__file__).parent / "csrc" / "slstm_scan.cu"
BWD_SRC = Path(ops.__file__).parent / "csrc" / "slstm_scan_bwd.cu"
DTYPES = [torch.float32, torch.bfloat16]


def _ctypes_of(decl: str) -> list:
    return [ctypes.c_void_p if "*" in a else ctypes.c_int
            for a in decl.split(",")]


def _c_decl(name: str, src: Path = KERNEL_SRC) -> str:
    return re.search(rf'extern "C" int {name}\((.*?)\)', src.read_text(),
                     re.S).group(1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 3, 4])
@pytest.mark.parametrize("b", [1, 2])
def test_plan_covers_every_column_and_row(b, heads, dtype):
    elem = torch.finfo(dtype).bits // 8
    for dh in range(1, ops.MAX_DH + 1):
        for t in (1, 16):
            plan = ops.plan_scan(b, t, heads, dh, dtype)
            # the kernel's cut: CTA q owns [q * cols, min((q + 1) * cols, dh))
            owned = [(q * plan.cols, min((q + 1) * plan.cols, dh))
                     for q in range(plan.n_cta)]
            cols = [j for start, stop in owned for j in range(start, stop)]
            assert cols == list(range(dh)), dh
            assert all(stop > start for start, stop in owned), dh
            assert 1 <= plan.n_cta <= ops.MAX_CLUSTER
            assert plan.cols <= ops.MAX_COLS
            assert plan.grid == (plan.n_cta, heads, b)
            assert plan.threads == ops.SLICES * (-(-plan.cols // 32) * 32)
            # every k row in exactly one slice; each slice's first rows in
            # registers, the next in shared memory, the rest streamed
            rows = [k for start, stop in ops.slices(dh)
                    for k in range(start, stop)]
            assert rows == list(range(dh)), dh
            assert plan.resident_rows + plan.streamed_rows == dh
            assert plan.resident_rows == sum(
                min(plan.register_rows + plan.rows_per_slice, stop - start)
                for start, stop in ops.slices(dh))
            assert plan.smem_bytes <= ops.SMEM_LIMIT == 232448
            assert plan.smem_bytes == ops.smem_bytes(
                dh, plan.cols, plan.rows_per_slice, elem)
            # the 256-thread build (32 columns or fewer) streams nothing
            if plan.threads == 256:
                assert plan.streamed_rows == 0, dh


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_serving_shape_plan(dtype):
    """xlstm-1.3b's sLSTM (H=4, dh=512): 16 CTAs of 32 columns a head, 64
    CTAs at batch 1, all of R on the chip; a decode step plans as a
    prefill does."""
    plan = ops.plan_scan(1, 16, 4, 512, dtype)
    assert (plan.n_cta, plan.cols, plan.threads) == (16, 32, 256)
    assert plan.grid == (16, 4, 1)
    assert plan.register_rows == 32
    assert plan.rows_per_slice == 32
    assert (plan.resident_rows, plan.streamed_rows) == (512, 0)
    assert plan == ops.plan_scan(1, 1, 4, 512, dtype)


@pytest.mark.parametrize("n_cta", [8, 16])
def test_cluster_size_override(n_cta):
    plan = ops.plan_scan(1, 16, 4, 512, torch.float32, n_cta)
    assert plan.n_cta == n_cta and plan.cols == 512 // n_cta


@pytest.mark.parametrize("dh,n_cta", [(512, 4), (512, 17), (1, 2),
                                      (33, 16), (2000, 16)])
def test_plan_refuses_impossible_splits(dh, n_cta):
    """More than 64 columns a CTA (512 over 4), more than 16 CTAs, a CTA
    left with no column (1 over 2; 33 over 16 in 3-column CTAs), or a head
    dim past MAX_DH."""
    with pytest.raises(ValueError):
        ops.plan_scan(1, 16, 1, dh, torch.float32, n_cta)


def test_constants_match_the_kernel():
    src = KERNEL_SRC.read_text()
    consts = {name: int(re.search(rf"{name} = (\d+);", src).group(1))
              for name in ("kSlices", "kMaxCols", "kMaxCluster", "kMaxDh",
                           "kMaxSmem")}
    assert consts == {"kSlices": ops.SLICES, "kMaxCols": ops.MAX_COLS,
                      "kMaxCluster": ops.MAX_CLUSTER, "kMaxDh": ops.MAX_DH,
                      "kMaxSmem": ops.SMEM_LIMIT}
    # register rows of the 256-thread build: 32 f32 words, or 16 words of
    # two bf16 rows
    words = re.search(r"return sizeof\(T\) == 4 \? (\d+) : (\d+);", src)
    assert int(words.group(1)) == ops.REG_ROWS == 2 * int(words.group(2))


def test_launcher_argtypes_match_the_c_entry_point():
    """The ctypes signatures set once in ``_lib`` against the C
    declarations: pointers, then ints, then the stream."""
    assert _ctypes_of(_c_decl("slstm_scan_launch")) == ops.ARGTYPES
    assert _ctypes_of(_c_decl("slstm_scan_max_clusters")) == \
        ops.MAX_CLUSTERS_ARGTYPES


def test_smem_bytes_matches_the_kernel_layout():
    """Two mbarriers, h[2][dh] and two sets of partial sums in f32, then R's
    shared-memory rows, as the kernel's smem_bytes() lays them out."""
    src = KERNEL_SRC.read_text()
    body = re.search(r"size_t smem_bytes\(int dh, int cols, int rps, "
                     r"int elem\) \{(.*?)\n\}", src, re.S).group(1)
    assert "16 + 2 * (size_t)pad4(dh) * sizeof(float)" in body
    assert "2 * kSlices * 4 * cp * sizeof(float)" in body
    assert "kSlices * (size_t)rps * 4 * cp * elem" in body
    assert ops.smem_bytes(512, 32, 32, 4) == \
        16 + 2 * 512 * 4 + 2 * 8 * 4 * 32 * 4 + 8 * 32 * 4 * 32 * 4
    assert ops.smem_bytes(100, 25, 0, 2) == \
        16 + 2 * 100 * 4 + 2 * 8 * 4 * 32 * 4


def test_phase_markers_are_in_the_kernel():
    """The phase timer (``phases.py``) patches the kernel source at fixed
    texts: each must occur exactly once, and the patched source reads the
    clock at every phase."""
    src = KERNEL_SRC.read_text()
    for plain, timed in phases.MARKERS:
        assert src.count(plain) == 1, plain
        assert "PHASE(" in timed
    timed_src = phases.instrumented_source()
    assert timed_src.count("PHASE(") == len(phases.MARKERS) + 1  # + #define
    assert "slstm_phases_read" in timed_src


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 4])
def test_backward_plan_covers_every_column_and_row(heads, dtype):
    """The backward's plan splits columns as the forward's (the same CTAs
    own the same columns), keeps its register rows of each j subslice,
    then shared-memory rows, within 227 KB, and streams nothing in the
    256-thread build."""
    elem = torch.finfo(dtype).bits // 8
    for dh in range(1, ops.MAX_DH + 1):
        plan = ops.plan_scan(1, 16, heads, dh, dtype, backward=True)
        fwd = ops.plan_scan(1, 16, heads, dh, dtype)
        assert (plan.n_cta, plan.cols, plan.threads, plan.grid) == \
            (fwd.n_cta, fwd.cols, fwd.threads, fwd.grid)
        assert plan.register_rows == (
            ops.BWD_REG_ROWS if plan.threads == 256 else 0)
        subs = ops.slices(dh, ops.BWD_SUBS)
        assert [j for start, stop in subs for j in range(start, stop)] == \
            list(range(dh))
        assert plan.resident_rows + plan.streamed_rows == dh
        assert plan.resident_rows == sum(
            min(plan.register_rows + plan.rows_per_slice, stop - start)
            for start, stop in subs)
        assert plan.smem_bytes <= ops.SMEM_LIMIT
        assert plan.smem_bytes == ops.bwd_smem_bytes(
            dh, plan.cols, plan.rows_per_slice, elem)
        if plan.threads == 256:
            assert plan.streamed_rows == 0, dh


@pytest.mark.parametrize("dtype,reg,rps,smem", [
    (torch.float32, 10, 6, 133200), (torch.bfloat16, 10, 6, 84048)])
def test_backward_train_shape_plan(dtype, reg, rps, smem):
    """xlstm-1.3b's sLSTM (H=4, dh=512) in the backward: 16 CTAs of 32
    columns a head, all of R^T on the chip in 32 subslices of 16 rows
    (10 rows of each in registers, 6 in shared memory), beside the ring of
    step inputs."""
    plan = ops.plan_scan(1, 4096, 4, 512, dtype, backward=True)
    assert (plan.n_cta, plan.cols, plan.threads) == (16, 32, 256)
    assert (plan.register_rows, plan.rows_per_slice) == (reg, rps)
    assert (plan.resident_rows, plan.streamed_rows) == (512, 0)
    assert plan.smem_bytes == smem
    # at most 32 of every 64 rows (a slice of 8) are read from shared
    # memory a step: at most 131,072 bytes of R^T a CTA in f32
    assert plan.rows_per_slice * ops.BWD_SUBS <= 32 * ops.SLICES
    elem = torch.finfo(dtype).bits // 8
    assert ops.BWD_SUBS * plan.rows_per_slice * 4 * plan.cols * elem \
        <= 131072


def test_backward_constants_match_the_kernel():
    src = BWD_SRC.read_text()
    consts = {name: int(re.search(rf"{name} = (\d+);", src).group(1))
              for name in ("kSlices", "kMaxCols", "kMaxCluster", "kMaxDh",
                           "kMaxSmem", "kSubs", "kRegRows", "kStages",
                           "kRuns", "kGated")}
    assert consts == {"kSlices": ops.SLICES, "kMaxCols": ops.MAX_COLS,
                      "kMaxCluster": ops.MAX_CLUSTER, "kMaxDh": ops.MAX_DH,
                      "kMaxSmem": ops.SMEM_LIMIT, "kSubs": ops.BWD_SUBS,
                      "kRegRows": ops.BWD_REG_ROWS,
                      "kStages": ops.BWD_STAGES, "kRuns": ops.BWD_RUNS,
                      "kGated": ops.BWD_GATED}


def test_backward_launcher_argtypes_match_the_c_entry_points():
    """The backward's ctypes signatures against its C declarations."""
    assert _ctypes_of(_c_decl("slstm_scan_bwd_launch", BWD_SRC)) == \
        ops.BWD_ARGTYPES
    assert _ctypes_of(_c_decl("slstm_scan_bwd_max_clusters", BWD_SRC)) == \
        ops.MAX_CLUSTERS_ARGTYPES
    assert _c_decl("slstm_scan_bwd_setup", BWD_SRC).strip() == "int dtype"


def test_backward_smem_bytes_matches_the_kernel_layout():
    """The mbarriers (two of the exchange, one a ring stage), the four gate
    gradients of every column [2][dh][4], one partial sum a subslice pair
    and column, double-buffered, the ring [stages][runs][cols + 4], the
    initial state with dh's seed [4][cols] and the gating threads' values
    for dh_t [4][gated][cols], in f32, then R^T's shared-memory rows, as
    the backward's smem_bytes() lays them out."""
    body = re.search(r"size_t smem_bytes\(int dh, int cols, int rps, "
                     r"int elem\) \{(.*?)\n\}", BWD_SRC.read_text(),
                     re.S).group(1)
    assert "pad16((2 + kStages) * 8) + 2 * (size_t)pad4(dh) * 4 * " \
        "sizeof(float)" in body
    assert "kSubs * cp * sizeof(float)" in body
    assert "kStages * kRuns * (cp + 4) * sizeof(float) + 4 * cp * " \
        "sizeof(float)" in body
    assert "kGaters * kGated * cp * sizeof(float)" in body
    assert "kSubs * (size_t)rps * 4 * cp * elem" in body
    ring = 8 * 8 * 36 * 4 + 4 * 32 * 4 + 4 * 9 * 32 * 4
    assert ops.bwd_smem_bytes(512, 32, 4, 4) == \
        80 + 2 * 512 * 16 + 2 * 16 * 32 * 4 + ring + 32 * 4 * 4 * 32 * 4
    assert ops.bwd_smem_bytes(48, 24, 0, 2) == \
        80 + 2 * 48 * 16 + 2 * 16 * 32 * 4 + ring


def test_the_backward_uses_no_atomics():
    """Run-to-run bit-identical results: no atomic or reduction to memory
    outside comments."""
    code = re.sub(r"//[^\n]*", "", BWD_SRC.read_text())
    assert not re.search(r"atomic|\bred\.", code)


def test_backward_phase_markers_are_in_the_kernel():
    """The backward's phase timer (``phases.py --bwd``) patches its source
    at fixed texts: each must occur exactly once, and the patched source
    reads the clock once a marker."""
    src = BWD_SRC.read_text()
    for plain, timed in phases.BWD_MARKERS:
        assert src.count(plain) == 1, plain
        assert timed.count("PHASE(") == 1, timed
    timed_src = phases.instrumented_source(backward=True)
    assert timed_src.count("PHASE(") == len(phases.BWD_MARKERS) + 1
    assert "slstm_phases_read" in timed_src
    assert len(phases.BWD_PHASES) == len(phases.BWD_MARKERS) - 2


def _run_window(dh: int, cols: int, heads: int, steps: int, q: int,
                run: int, t: int, head: int, b: int) -> tuple[int, int, int]:
    """The kernel's bulk copy of ring run ``run`` for step t in CTA q
    (``run_start`` and ``fill``): (first float copied, floats copied, the
    owned column's offset in the copy)."""
    col0 = q * cols
    n_own = min(cols, dh - col0)
    if run < 4:
        e0 = (((b * steps + t) * 4 + run) * heads + head) * dh + col0
    else:
        step = t - 1 if run < 7 else t
        e0 = ((b * steps + step) * heads + head) * dh + col0
    a0, a1 = e0 & ~3, (e0 + n_own + 3) & ~3
    return a0, a1 - a0, e0 - a0


@pytest.mark.parametrize("dh", [1, 3, 24, 48, 100, 510, 512, 700, 1024])
def test_backward_ring_copies_fit_their_runs(dh):
    """Every bulk copy of a step's inputs starts on a 16-byte bound, moves a
    multiple of 16 bytes, holds the CTA's owned columns, fits a ring run of
    cols_pad + 4 floats, and ends inside the 16 bytes that hold the
    tensor's last element (the tensors start 16-byte aligned), for every
    CTA, run and step at two batch rows and three heads."""
    heads, bsz, steps = 3, 2, 3
    plan = ops.plan_scan(bsz, steps, heads, dh, torch.float32, backward=True)
    cp = -(-plan.cols // 32) * 32
    sizes = {"pre": bsz * steps * 4 * heads * dh,
             "state": bsz * steps * heads * dh}
    for q in range(plan.n_cta):
        n_own = min(plan.cols, dh - q * plan.cols)
        for run in range(ops.BWD_RUNS):
            numel = sizes["pre" if run < 4 else "state"]
            for b in range(bsz):
                for head in range(heads):
                    for t in range(1 if 4 <= run < 7 else 0, steps):
                        a0, n, off = _run_window(dh, plan.cols, heads, steps,
                                                 q, run, t, head, b)
                        assert a0 % 4 == 0 and n % 4 == 0 and n > 0
                        assert off + n_own <= n <= cp + 4
                        assert a0 + n <= -(-numel // 4) * 4


def _product_order(rt: torch.Tensor, dpre: torch.Tensor, n_cta: int,
                   reg_rows: int, rps: int, chunk: int = 1) -> torch.Tensor:
    """dh_{t-1} = sum_g sum_j R[g, k, j] dpre[g, j] in the kernel's order, in
    float32: CTA q owns columns [q * cols, ...); the product's threads run
    their j subslice's register rows, then its shared-memory rows, then
    the streamed ones chunk by chunk, each row one multiply-add a gate and
    column into that accumulator (the product exact in float64, the sum
    rounded to float32, as a fused multiply-add rounds but for double
    rounding's rare ties); a column's four are added as (a0 + a1) +
    (a2 + a3), subslices 2k and 2k + 1 in pairs, the 16 pair sums in four
    runs of four in order, and the runs as (r0 + r1) + (r2 + r3)."""
    dh = rt.shape[-1]
    cols = -(-dh // n_cta)
    out = torch.empty(dh, dtype=torch.float32)
    for q in range(n_cta):
        ks = slice(q * cols, min(dh, (q + 1) * cols))
        r_q = rt[:, :, ks].double()            # [4, j, own columns]
        parts = []
        for start, stop in ops.slices(dh, ops.BWD_SUBS):
            nreg = min(reg_rows, stop - start)
            nres = min(rps, stop - start - nreg)
            acc = torch.zeros((4, r_q.shape[-1]), dtype=torch.float32)
            reg = range(start, start + nreg)
            res = range(start + nreg, start + nreg + nres)
            streamed = range(start + nreg + nres, stop)
            chunks = [streamed[i:i + chunk]
                      for i in range(0, len(streamed), chunk)]
            for rows in (reg, res, *chunks):
                for j in rows:
                    acc = (dpre[:, j, None].double() * r_q[:, j]
                           + acc.double()).float()
            parts.append((acc[0] + acc[1]) + (acc[2] + acc[3]))
        pairs = [parts[2 * k] + parts[2 * k + 1] for k in range(16)]
        runs = []
        for r in range(4):
            run = pairs[4 * r]
            for p in pairs[4 * r + 1:4 * r + 4]:
                run = run + p
            runs.append(run)
        out[ks] = (runs[0] + runs[1]) + (runs[2] + runs[3])
    return out


@pytest.mark.parametrize("dh", [48, 100, 512])
def test_backward_sum_order_is_independent_of_the_plan(dh):
    """The property behind the card's "16 vs 8 CTAs bit-identical": the
    recurrence's share of dh_{t-1}, summed in the kernel's order, comes
    out bit for bit the same for every cluster size the plan allows and
    every split of a slice's rows between registers, shared memory and the
    stream; and it is the product it claims to be."""
    gen = torch.Generator().manual_seed(dh)
    rt = torch.randn((4, dh, dh), generator=gen) * dh ** -0.5
    dpre = torch.randn((4, dh), generator=gen)
    kc = -(-dh // ops.BWD_SUBS)
    sizes = []
    for n in range(1, ops.MAX_CLUSTER + 1):
        try:
            sizes.append(ops.plan_scan(1, 1, 1, dh, torch.float32, n,
                                       backward=True).n_cta)
        except ValueError:
            pass
    assert sizes and ops.plan_scan(1, 1, 1, dh, torch.float32,
                                   backward=True).n_cta in sizes
    splits = [(0, 0), (kc, 0), (0, kc), (min(12, kc), kc), (1, 2)]
    want = _product_order(rt, dpre, sizes[0], *splits[0])
    torch.testing.assert_close(
        want, torch.einsum("gjk,gj->k", rt.double(), dpre.double()).float(),
        rtol=1e-5, atol=1e-5)
    for n_cta in sizes:
        for reg_rows, rps in splits:
            got = _product_order(rt, dpre, n_cta, reg_rows, rps)
            assert torch.equal(got, want), (n_cta, reg_rows, rps)
