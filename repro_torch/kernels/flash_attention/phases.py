"""Where the flash attention kernel's time goes, phase by phase, on the card.

    python3 -m repro_torch.kernels.flash_attention.phases

Builds a copy of ``csrc/flash_attention.cu`` in which thread 0 of CTA
(0, 0, 0) -- the latest rows, so the CTA with the most K tiles under a
causal mask -- reads the SM clock (``clock64``) and the global timer at the
kernel's phase boundaries.  It runs the shapes of ``chip_smoke.py``'s flash
cases that matter most (qwen2's heads at T=16 and T=1024, deepseek-7b's
(H = KV = 32, D = 128) at T=1024, both dtypes) and prints, per call, the cycles of the prologue (the
tile flags and the visit list, the first loads) and, as a mean over the
steps of that CTA's walk (a K tile for each key group), those of each
step's phases.  The timed kernel is
the shipped one plus the clock reads and their stores.  Needs nvcc and a
card; nothing runs at import.
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
# must occur exactly once (tests/test_torch_flash_plan.py checks it)
MARKERS = (
    ("  const T* v = static_cast<const T*>(p.v);\n",
     "  const T* v = static_cast<const T*>(p.v);\n  PHASE(0);\n"),
    ("  __syncthreads();\n  if (warp == 0) {",
     "  __syncthreads();\n  PHASE(1);\n  if (warp == 0) {"),
    ("  const int count = *count_s;\n",
     "  const int count = *count_s;\n  PHASE(2);\n"),
    ("  // This thread's two rows:",
     "  PHASE(3);\n  // This thread's two rows:"),
    ("    cp_async_wait<ST - 2>();\n",
     "    PHASE(16 + 8 * i);\n    cp_async_wait<ST - 2>();\n"),
    ("    __syncthreads();          // step i landed; step i - 1 fully consumed\n",
     "    __syncthreads();          // step i landed; step i - 1 fully consumed\n"
     "    PHASE(17 + 8 * i);\n"),
    ("    cp_async_commit();\n\n    const int visit = i * ks + grp;\n",
     "    cp_async_commit();\n    PHASE(18 + 8 * i);\n\n"
     "    const int visit = i * ks + grp;\n"),
    ("    if (!active || visit >= count) continue;\n",
     "    PHASE(19 + 8 * i);\n    if (!active || visit >= count) continue;\n"),
    ("    // mask, online softmax; s becomes P\n",
     "    PHASE(20 + 8 * i);\n    // mask, online softmax; s becomes P\n"),
    ("    // O += P V;",
     "    PHASE(21 + 8 * i);\n    // O += P V;"),
    ("  cp_async_wait<0>();\n\n",
     "  PHASE(4);\n  cp_async_wait<0>();\n\n"),
)
SLOTS = 2048
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
extern "C" int flash_phases_read(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}}
extern "C" int flash_phases_clear() {{
  static unsigned long long zero[2 * {SLOTS}];
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}}
"""
# slots 16 + 8i .. 21 + 8i of step i (a tile for each key group; thread 0
# is in group 0); the next step's first (or slot 4) ends it
TILE_PHASES = ("wait + barrier", "issue next loads", "f32 split + barrier",
               "S = Q K^T", "mask + softmax", "O += P V")
CASES = (  # (label, T, H, KV, D)
    ("qwen2 T=16", 16, 14, 2, 64),
    ("qwen2 T=1024", 1024, 14, 2, 64),
    ("deepseek-7b T=1024", 1024, 32, 32, 128),
)


def instrumented_source() -> str:
    src = next(p for p in _build.sources(ops.NAME)
               if p.name == "flash_attention.cu").read_text()
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
    cu = _build.BUILD_DIR / f"flash_phases-{tag}.cu"
    lib = _build.BUILD_DIR / f"libflash_phases-{tag}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu.write_text(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(cu)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    so.flash_attention_launch.argtypes = ops.ARGTYPES
    so.flash_attention_launch.restype = ctypes.c_int
    so.flash_phases_read.argtypes = [ctypes.c_void_p]
    so.flash_phases_clear.argtypes = []
    so.flash_attention_setup.argtypes = []
    return so


def run(so, label: str, dtype, t: int, h: int, kv: int, d: int) -> str:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, t, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, t, kv, d), generator=gen, device="cuda").to(dtype)
    pos = torch.arange(t, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    plan = ops.plan_flash(1, t, t, h, kv, d, dtype)
    visits = len(ops.visit_list(plan, pos.tolist(), pos.tolist(), h // kv,
                                0, True, 0))
    steps = -(-visits // plan.key_groups)
    _build.check(so.flash_attention_setup(), "flash_phases")
    for _ in range(3):                        # warm: inputs in L2
        _build.check(so.flash_phases_clear(), "flash_phases")
        _build.check(so.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            pos.data_ptr(), out.data_ptr(), 1, t, t, h, kv, d, 1, 0,
            _build.DTYPE_CODES[dtype], plan.rows, plan.key_groups,
            plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream), "flash_phases")
        torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * SLOTS))()
    _build.check(so.flash_phases_read(ctypes.addressof(buf)), "flash_phases")
    cyc, ns = list(buf[:SLOTS]), list(buf[SLOTS:])
    n = min(steps, (SLOTS - 16) // 8)
    ends = [cyc[16 + 8 * (i + 1)] for i in range(n - 1)] + [cyc[4]]
    tiles = []
    for i in range(n):
        marks = [cyc[16 + 8 * i + j] for j in range(6)] + [ends[i]]
        tiles.append([b - a for a, b in zip(marks, marks[1:])])
    mean = [sum(tl[j] for tl in tiles) / n for j in range(6)]
    ghz = (cyc[4] - cyc[0]) / max(1, ns[4] - ns[0])
    per_tile = ", ".join(f"{name} {c:.0f}"
                         for name, c in zip(TILE_PHASES, mean))
    return (f"[phases] flash_attention {label} H={h} KV={kv} D={d} "
            f"{str(dtype)[6:]}: plan rows={plan.rows} key groups="
            f"{plan.key_groups} grid={plan.grid} BK={plan.tile_keys}; CTA "
            f"(0,0,0) visits {visits} of {plan.n_key_tiles} K tiles in "
            f"{steps} steps; flags {cyc[1] - cyc[0]} cycles, "
            f"list {cyc[2] - cyc[1]}, first loads and Q {cyc[3] - cyc[2]}; "
            f"per step (mean of {n}): {per_tile}; step "
            f"{sum(mean):.0f} cycles; whole CTA {cyc[4] - cyc[0]} cycles at "
            f"{ghz:.3f} GHz")


def main() -> int:
    if not torch.cuda.is_available():
        print("phases: no CUDA device available", file=sys.stderr)
        return 2
    so = build()
    for dtype in (torch.float32, torch.bfloat16):
        for case in CASES:
            print(run(so, case[0], dtype, *case[1:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
