"""Where the sLSTM scan kernel's time goes, phase by phase, on the card.

    python3 -m repro_torch.kernels.slstm_scan.phases

Builds a copy of ``csrc/slstm_scan.cu`` in which thread 0 of CTA (0, 0, 0)
reads the SM clock (``clock64``) and the global timer at the kernel's phase
boundaries, runs it at xlstm-1.3b's serving shape (B=1, H=4, dh=512: T=16
from the zero state and T=1 from a carried one, f32 and bf16) and prints,
per call, the cycles of the set-up (R into registers and shared memory, the
first exchange of h) and, as a mean over the steps, those of each step's
phases.  The timed kernel is the shipped one plus the clock reads and their
stores.  Needs nvcc and a card; nothing runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
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
SLOTS = 1024
HEADER = f"""
__device__ unsigned long long g_phase[2 * {SLOTS}];
#define PHASE(slot)                                                         \\
  do {{                                                                      \\
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&            \\
        threadIdx.x == 0 && (slot) < {SLOTS}) {{                             \\
      unsigned long long ns;                                                \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                \\
      g_phase[slot] = clock64();                                            \\
      g_phase[{SLOTS} + (slot)] = ns;                                       \\
    }}                                                                      \\
  }} while (0)
extern "C" int slstm_phases_read(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}}
"""
STEP_PHASES = ("loads before the wait", "exchange wait", "register rows",
               "shared-memory rows", "partial sums + barrier", "gating + send")


def instrumented_source() -> str:
    src = _build.sources(ops.NAME)[0].read_text()
    for plain, timed in MARKERS:
        if src.count(plain) != 1:
            raise RuntimeError(f"phase marker not found once in the kernel: "
                               f"{plain!r}")
        src = src.replace(plain, timed)
    head = "#include <stdint.h>\n"
    return src.replace(head, head + HEADER, 1)


def build() -> ctypes.CDLL:
    src = instrumented_source()
    tag = hashlib.sha1(src.encode()).hexdigest()[:12]
    cu = _build.BUILD_DIR / f"slstm_phases-{tag}.cu"
    lib = _build.BUILD_DIR / f"libslstm_phases-{tag}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(cu)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.slstm_scan_launch.argtypes = ops.ARGTYPES
    so.slstm_scan_launch.restype = ctypes.c_int
    so.slstm_scan_setup.argtypes = [ctypes.c_int]
    so.slstm_phases_read.argtypes = [ctypes.c_void_p]
    return so


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
    buf = (ctypes.c_ulonglong * (2 * SLOTS))()
    _build.check(so.slstm_phases_read(ctypes.addressof(buf)), "slstm_phases")
    cyc, ns = list(buf[:SLOTS]), list(buf[SLOTS:])
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


def main() -> int:
    if not torch.cuda.is_available():
        print("phases: no CUDA device available", file=sys.stderr)
        return 2
    so = build()
    for dtype in (torch.float32, torch.bfloat16):
        for t, with_state in ((16, False), (1, True)):
            print(run(so, dtype, t, with_state))
    return 0


if __name__ == "__main__":
    sys.exit(main())
