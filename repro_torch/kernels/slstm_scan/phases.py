"""Where the sLSTM kernels' time goes, phase by phase, on the card.

    python3 -m repro_torch.kernels.slstm_scan.phases          # the scan
    python3 -m repro_torch.kernels.slstm_scan.phases --bwd    # its backward

Builds a copy of ``csrc/slstm_scan.cu`` (with ``--bwd``,
``csrc/slstm_scan_bwd.cu``) in which thread 0 of CTA (0, 0, 0) reads the SM
clock (``clock64``) and the global timer at the kernel's phase boundaries.
The scan runs at xlstm-1.3b's serving shape (B=1, H=4, dh=512: T=16 from
the zero state and T=1 from a carried one, f32 and bf16) and prints, per
call, the cycles of the set-up (R into registers and shared memory, the
first exchange of h) and, as a mean over the steps, those of each step's
phases.  The backward runs at the train step's heads (B=1, H=4, dh=512,
T=1024 and 4096 from the zero state, f32 and bf16, on the tensors of the
scan's saving mode) and prints the same for its steps, then times the
shipped launch alone: five launches one after another and five each after
a 256 MiB write that flushes L2, each between CUDA events (min / median /
max ms, us a step).  The timed kernel is the shipped one plus the clock
reads and their stores.  Needs nvcc and a card; nothing runs at import.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys

import torch

from .. import _build
from . import ops

# (text in the kernel source, the same text with a clock read); each text
# must occur exactly once (tests/test_torch_slstm_plan.py checks it)
MARKERS = (
    ("  const int col = col0 + (active ? c : 0);\n",
     "  const int col = col0 + (active ? c : 0);\n  PHASE(0);\n"),
    ("  send(h, 0);\n  __syncthreads();\n",
     "  send(h, 0);\n  __syncthreads();\n  PHASE(1);\n"),
    ("    const unsigned bar = bar_base + 8u * cur;\n",
     "    PHASE(8 + 6 * t);\n    const unsigned bar = bar_base + 8u * cur;\n"),
    ("    mbar_wait(bar, (t >> 1) & 1);\n",
     "    mbar_wait(bar, (t >> 1) & 1);\n    PHASE(9 + 6 * t);\n"),
    ("      // shared-memory rows, four at a time",
     "      PHASE(10 + 6 * t);\n      // shared-memory rows, four at a time"),
    ("    // partial sums double-buffered",
     "    PHASE(11 + 6 * t);\n    // partial sums double-buffered"),
    ("    __syncthreads();\n\n    if (gater) {",
     "    __syncthreads();\n    PHASE(12 + 6 * t);\n\n    if (gater) {"),
    ("    cur ^= 1;\n  }\n",
     "    PHASE(13 + 6 * t);\n    cur ^= 1;\n  }\n"),
)
STEP_PHASES = ("loads before the wait", "exchange wait", "register rows",
               "shared-memory rows", "partial sums + barrier", "gating + send")

# The backward's, over iteration s (which gates step T - 1 - s after the
# product of step T - s's dpre): BWD_STRIDE slots an iteration.  Before the
# clock read that ends the input wait, a branch on the step's inputs makes
# the thread wait for them to be in registers.  The texts also occur once
# in the kernel's previous design (a column a thread over 64-row slices,
# its inputs loaded from device memory each step), so this file times that
# version too, run from an unpacked tree of its commit.  The first phase
# holds the ring's wait and the gating that needs no dh (the step's loads
# in the previous design); the sixth the pair sums' reduction too.
BWD_STRIDE = 10
BWD_MARKERS = (
    ("  const int col = col0 + (active ? c : 0);\n",
     "  const int col = col0 + (active ? c : 0);\n  PHASE(0);\n"),
    ("  __syncthreads();              // every thread's shared-memory rows "
     "landed\n",
     "  __syncthreads();              // every thread's shared-memory rows "
     "landed\n  PHASE(1);\n"),
    ("    const int t = steps - 1 - s;\n",
     "    const int t = steps - 1 - s;\n    PHASE(8 + 10 * s);\n"),
    ("      const unsigned bar = bar_base + 8u * cur;\n",
     "      PHASE(9 + 10 * s);\n      const unsigned bar = bar_base + 8u * "
     "cur;\n"),
    ("      mbar_wait(bar, (q >> 1) & 1);\n",
     "      mbar_wait(bar, (q >> 1) & 1);\n      PHASE(10 + 10 * s);\n"),
    ("        // shared-memory rows\n",
     "        PHASE(11 + 10 * s);\n        // shared-memory rows\n"),
    ("      // partial sums double-buffered",
     "      PHASE(12 + 10 * s);\n      // partial sums double-buffered"),
    ("    }\n\n    if (!gater) continue;\n",
     "    }\n    PHASE(13 + 10 * s);\n\n    if (!gater) continue;\n"),
    ("    const float dhv = dh_up + rec;\n",
     "    if (__float_as_uint(dh_up + c_prev + n_prev) == 0x7f800001u)\n"
     "      asm volatile(\"trap;\");\n"
     "    PHASE(14 + 10 * s);\n    const float dhv = dh_up + rec;\n"),
    ("    dm = da;\n", "    dm = da;\n    PHASE(15 + 10 * s);\n"),
    ("    send(d, s & 1);\n",
     "    send(d, s & 1);\n    PHASE(16 + 10 * s);\n"),
)
BWD_PHASES = ("before the exchange wait", "exchange wait", "register rows",
              "shared-memory rows", "partial sums + barrier",
              "the step's inputs", "gating", "sends", "dpre stores + loop")
SLOTS = 1024
BWD_T = (1024, 4096)
BWD_SLOTS = 8 + BWD_STRIDE * (max(BWD_T) + 1)


def header(slots: int) -> str:
    return f"""
__device__ unsigned long long g_phase[2 * {slots}];
#define PHASE(slot)                                                         \\
  do {{                                                                      \\
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&            \\
        threadIdx.x == 0 && (slot) < {slots}) {{                             \\
      unsigned long long ns;                                                \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                \\
      g_phase[slot] = clock64();                                            \\
      g_phase[{slots} + (slot)] = ns;                                       \\
    }}                                                                      \\
  }} while (0)
extern "C" int slstm_phases_read(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}}
"""


def instrumented_source(backward: bool = False) -> str:
    src = _build.sources(ops.NAME)[1 if backward else 0].read_text()
    for plain, timed in BWD_MARKERS if backward else MARKERS:
        if src.count(plain) != 1:
            raise RuntimeError(f"phase marker not found once in the kernel: "
                               f"{plain!r}")
        src = src.replace(plain, timed)
    head = "#include <stdint.h>\n"
    return src.replace(head, head + header(BWD_SLOTS if backward else SLOTS),
                       1)


def build(backward: bool = False) -> ctypes.CDLL:
    src = instrumented_source(backward)
    tag = hashlib.sha1(src.encode()).hexdigest()[:12]
    cu = _build.BUILD_DIR / f"slstm_phases-{tag}.cu"
    lib = _build.BUILD_DIR / f"libslstm_phases-{tag}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(cu)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    if backward:
        so.slstm_scan_bwd_launch.argtypes = ops.BWD_ARGTYPES
        so.slstm_scan_bwd_launch.restype = ctypes.c_int
        so.slstm_scan_bwd_setup.argtypes = [ctypes.c_int]
    else:
        so.slstm_scan_launch.argtypes = ops.ARGTYPES
        so.slstm_scan_launch.restype = ctypes.c_int
        so.slstm_scan_setup.argtypes = [ctypes.c_int]
    so.slstm_phases_read.argtypes = [ctypes.c_void_p]
    return so


def _read(so, slots: int) -> tuple[list, list]:
    buf = (ctypes.c_ulonglong * (2 * slots))()
    _build.check(so.slstm_phases_read(ctypes.addressof(buf)), "slstm_phases")
    return list(buf[:slots]), list(buf[slots:])


def run(so, dtype, t: int, with_state: bool, b: int = 1, heads: int = 4,
        dh: int = 512) -> str:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wx = (0.5 * torch.randn((b, t, 4, heads, dh), generator=gen,
                            device="cuda")).to(dtype)
    r = (dh ** -0.5 * torch.randn((4, heads, dh, dh), generator=gen,
                                  device="cuda")).to(dtype)
    bias = 0.1 * torch.randn((4, heads, dh), generator=gen, device="cuda")
    h, c = (torch.rand((b, heads, dh), generator=gen, device="cuda")
            for _ in range(2))
    state = [h, c, 1.0 + torch.rand_like(h), torch.zeros_like(h)]
    outs = [torch.empty_like(s) for s in state]
    hs = torch.empty((b, t, heads, dh), device="cuda")
    plan = ops.plan_scan(b, t, heads, dh, dtype)
    ins = [s.data_ptr() for s in state] if with_state else [None] * 4
    code = _build.DTYPE_CODES[dtype]
    _build.check(so.slstm_scan_setup(code), "slstm_phases")
    for _ in range(3):                        # warm: R in L2, as in a scan
        _build.check(so.slstm_scan_launch(
            wx.data_ptr(), r.data_ptr(), bias.data_ptr(), *ins,
            hs.data_ptr(), *(o.data_ptr() for o in outs), *[None] * 4, b,
            t, heads, dh,
            code, plan.n_cta, plan.cols, plan.rows_per_slice,
            plan.smem_bytes, torch.cuda.current_stream().cuda_stream),
            "slstm_phases")
        torch.cuda.synchronize()
    cyc, ns = _read(so, SLOTS)
    steps = [[cyc[8 + 6 * i + j] for j in range(6)] for i in range(t)]
    prev = [cyc[1]] + [s[5] for s in steps[:-1]]
    phases = [sum(s[j] - (p if j == 0 else s[j - 1])
                  for s, p in zip(steps, prev)) / t for j in range(6)]
    total = steps[-1][5] - cyc[0]
    ghz = total / (ns[8 + 6 * (t - 1) + 5] - ns[0])
    per_step = ", ".join(f"{name} {c:.0f}"
                         for name, c in zip(STEP_PHASES, phases))
    return (f"[phases] slstm_scan B={b} H={heads} dh={dh} T={t} "
            f"{'carried' if with_state else 'zero'} state "
            f"{str(dtype)[6:]}: set-up {cyc[1] - cyc[0]} cycles; per step "
            f"(mean of {t}): {per_step}; step {sum(phases):.0f} cycles; "
            f"whole call {total} cycles at {ghz:.3f} GHz")


def _bwd_inputs(dtype, t: int, b: int, heads: int, dh: int) -> tuple:
    """R^T, the saving forward's tensors and an upstream gradient, from
    seed 0."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    wx = (0.5 * torch.randn((b, t, 4, heads, dh), generator=gen,
                            device="cuda")).to(dtype)
    r = (dh ** -0.5 * torch.randn((4, heads, dh, dh), generator=gen,
                                  device="cuda")).to(dtype)
    bias = 0.1 * torch.randn((4, heads, dh), generator=gen, device="cuda")
    _, _, saved = ops.slstm_scan_saving(wx, r, bias)
    dhs = torch.randn((b, t, heads, dh), generator=gen, device="cuda")
    return r.transpose(2, 3).contiguous(), saved, dhs


def _bwd_launch(fn, plan, rt, saved, dhs, outs):
    b, t, _, heads, dh = saved[0].shape
    _build.check(fn(
        rt.data_ptr(), *(x.data_ptr() for x in saved), *[None] * 3,
        dhs.data_ptr(), *[None] * 4, *(x.data_ptr() for x in outs), b, t,
        heads, dh, _build.DTYPE_CODES[rt.dtype], plan.n_cta, plan.cols,
        plan.rows_per_slice, plan.smem_bytes,
        torch.cuda.current_stream().cuda_stream), "slstm_phases")


def bwd_launch_ms(rt, saved, dhs, n: int = 5, cold: bool = False) -> list:
    """Device ms of each of ``n`` launches of the shipped backward kernel
    (``ops``'s library; uncounted) on R^T and the saving forward's tensors
    from the zero state with no final-state gradient, one after another,
    or each after a 256 MiB write that flushes L2 with ``cold``; each
    between CUDA events."""
    b, t, _, heads, dh = saved[0].shape
    plan = ops.plan_scan(b, t, heads, dh, rt.dtype, backward=True)
    ops.max_active_clusters(plan, rt.dtype, rt.device, backward=True)
    outs = (torch.empty_like(saved[0]),
            *(torch.empty((b, heads, dh), device=rt.device)
              for _ in range(4)))
    flush = torch.empty(64 * 2**20, device=rt.device) if cold else None
    fn = ops._lib()[1]
    events = []
    for _ in range(n):
        if cold:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _bwd_launch(fn, plan, rt, saved, dhs, outs)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def spread(ms: list) -> str:
    return (f"min {min(ms):.5f} / median {statistics.median(ms):.5f} / max "
            f"{max(ms):.5f} ms")


def run_bwd(so, dtype, t: int, b: int = 1, heads: int = 4,
            dh: int = 512) -> list[str]:
    rt, saved, dhs = _bwd_inputs(dtype, t, b, heads, dh)
    plan = ops.plan_scan(b, t, heads, dh, dtype, backward=True)
    _build.check(so.slstm_scan_bwd_setup(_build.DTYPE_CODES[dtype]),
                 "slstm_phases")
    outs = (torch.empty_like(saved[0]),
            *(torch.empty((b, heads, dh), device="cuda") for _ in range(4)))
    for _ in range(2):
        _bwd_launch(so.slstm_scan_bwd_launch, plan, rt, saved, dhs, outs)
        torch.cuda.synchronize()
    cyc, ns = _read(so, BWD_SLOTS)
    # iterations 1 .. t-1 pass every marker; each ends at the next one's
    # first
    it = [[cyc[8 + BWD_STRIDE * s + k] for k in range(9)]
          for s in range(1, t + 1)]
    phases = [sum(it[i][k] - it[i][k - 1] for i in range(t - 1)) / (t - 1)
              for k in range(1, 9)]
    phases.append(sum(it[i + 1][0] - it[i][8] for i in range(t - 1))
                  / (t - 1))
    end = 8 + BWD_STRIDE * t + 5          # the last product's partial sums
    total = cyc[end] - cyc[0]
    ghz = total / (ns[end] - ns[0])
    per_step = ", ".join(f"{name} {c:.0f}"
                         for name, c in zip(BWD_PHASES, phases))
    label = (f"[phases] slstm_scan_bwd B={b} H={heads} dh={dh} T={t} "
             f"{str(dtype)[6:]}")
    wall = ns[end] - ns[0]
    lines = [f"{label}: set-up {cyc[1] - cyc[0]} cycles; per step (mean of "
             f"{t - 1}): {per_step}; step {sum(phases):.0f} cycles; whole "
             f"call {total} cycles at {ghz:.3f} GHz ({wall / 1e6:.5f} ms, "
             f"{wall / 1e3 / t:.4f} us a step, with the clock reads)"]
    # the shipped launch, untimed inside
    for cold in (False, True):
        ms = bwd_launch_ms(rt, saved, dhs, cold=cold)
        how = "each after an L2 flush" if cold else "back to back"
        lines.append(
            f"{label}: the shipped launch, 5 {how}: {spread(ms)}; "
            f"{1e3 * statistics.median(ms) / t:.4f} us a step; each "
            + ", ".join(f"{x:.5f}" for x in ms))
    return lines


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bwd", action="store_true",
                        help="time the backward kernel")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("phases: no CUDA device available", file=sys.stderr)
        return 2
    print(f"[phases] card: {card_line()}")
    so = build(args.bwd)
    for dtype in (torch.float32, torch.bfloat16):
        if args.bwd:
            for t in BWD_T:
                for line in run_bwd(so, dtype, t):
                    print(line, flush=True)
        else:
            for t, with_state in ((16, False), (1, True)):
                print(run(so, dtype, t, with_state))
    return 0


if __name__ == "__main__":
    sys.exit(main())
