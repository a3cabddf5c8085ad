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
    own the same columns), keeps its register rows, then shared-memory
    rows, within 227 KB, and streams nothing in the 256-thread build."""
    elem = torch.finfo(dtype).bits // 8
    for dh in range(1, ops.MAX_DH + 1):
        plan = ops.plan_scan(1, 16, heads, dh, dtype, backward=True)
        fwd = ops.plan_scan(1, 16, heads, dh, dtype)
        assert (plan.n_cta, plan.cols, plan.threads, plan.grid) == \
            (fwd.n_cta, fwd.cols, fwd.threads, fwd.grid)
        assert plan.register_rows == (
            ops.BWD_REG_WORDS * (4 // elem) if plan.threads == 256 else 0)
        assert plan.resident_rows + plan.streamed_rows == dh
        assert plan.resident_rows == sum(
            min(plan.register_rows + plan.rows_per_slice, stop - start)
            for start, stop in ops.slices(dh))
        assert plan.smem_bytes <= ops.SMEM_LIMIT
        assert plan.smem_bytes == ops.bwd_smem_bytes(
            dh, plan.cols, plan.rows_per_slice, elem)
        if plan.threads == 256:
            assert plan.streamed_rows == 0, dh


@pytest.mark.parametrize("dtype,reg,rps,smem", [
    (torch.float32, 16, 48, 215056), (torch.bfloat16, 32, 32, 83984)])
def test_backward_train_shape_plan(dtype, reg, rps, smem):
    """xlstm-1.3b's sLSTM (H=4, dh=512) in the backward: 16 CTAs of 32
    columns a head, all of R^T on the chip (f32: 16 rows a slice in
    registers, 48 in shared memory)."""
    plan = ops.plan_scan(1, 4096, 4, 512, dtype, backward=True)
    assert (plan.n_cta, plan.cols, plan.threads) == (16, 32, 256)
    assert (plan.register_rows, plan.rows_per_slice) == (reg, rps)
    assert (plan.resident_rows, plan.streamed_rows) == (512, 0)
    assert plan.smem_bytes == smem


def test_backward_constants_match_the_kernel():
    src = BWD_SRC.read_text()
    consts = {name: int(re.search(rf"{name} = (\d+);", src).group(1))
              for name in ("kSlices", "kMaxCols", "kMaxCluster", "kMaxDh",
                           "kMaxSmem", "kRegWords")}
    assert consts == {"kSlices": ops.SLICES, "kMaxCols": ops.MAX_COLS,
                      "kMaxCluster": ops.MAX_CLUSTER, "kMaxDh": ops.MAX_DH,
                      "kMaxSmem": ops.SMEM_LIMIT,
                      "kRegWords": ops.BWD_REG_WORDS}


def test_backward_launcher_argtypes_match_the_c_entry_points():
    """The backward's ctypes signatures against its C declarations."""
    assert _ctypes_of(_c_decl("slstm_scan_bwd_launch", BWD_SRC)) == \
        ops.BWD_ARGTYPES
    assert _ctypes_of(_c_decl("slstm_scan_bwd_max_clusters", BWD_SRC)) == \
        ops.MAX_CLUSTERS_ARGTYPES
    assert _c_decl("slstm_scan_bwd_setup", BWD_SRC).strip() == "int dtype"


def test_backward_smem_bytes_matches_the_kernel_layout():
    """Two mbarriers, the four gate gradients of every column [2][dh][4]
    and one partial sum a slice and column, double-buffered, in f32, then
    R^T's shared-memory rows, as the backward's smem_bytes() lays them
    out."""
    body = re.search(r"size_t smem_bytes\(int dh, int cols, int rps, "
                     r"int elem\) \{(.*?)\n\}", BWD_SRC.read_text(),
                     re.S).group(1)
    assert "16 + 2 * (size_t)pad4(dh) * 4 * sizeof(float)" in body
    assert "2 * kSlices * cp * sizeof(float)" in body
    assert "kSlices * (size_t)rps * 4 * cp * elem" in body
    assert ops.bwd_smem_bytes(512, 32, 48, 4) == \
        16 + 2 * 512 * 16 + 2 * 8 * 32 * 4 + 8 * 48 * 4 * 32 * 4
    assert ops.bwd_smem_bytes(48, 24, 0, 2) == 16 + 2 * 48 * 16 + 2 * 8 * 32 * 4


def test_the_backward_uses_no_atomics():
    """Run-to-run bit-identical results: no atomic or reduction to memory
    outside comments."""
    code = re.sub(r"//[^\n]*", "", BWD_SRC.read_text())
    assert not re.search(r"atomic|\bred\.", code)
