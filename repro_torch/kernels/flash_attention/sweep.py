"""The flash attention kernel at every plan it can take, on the card.

    python3 -m repro_torch.kernels.flash_attention.sweep

For prompts at qwen2-0.5b's heads (H=14, KV=2, D=64; T=16 to 2048) and
deepseek-7b's (H = KV = 32, D = 128; T=16 and 1024), causal, in f32 and
bf16, times the kernel by CUDA-graph replay at every rows-per-CTA and
key-group count whose shared memory and threads fit, checks each against
the wrapper's output, and marks the one ``plan_flash`` picks (``[sweep]``
lines).  This is how the plan's rules were chosen.  Needs nvcc and a
card; nothing runs at import.
"""
from __future__ import annotations

import sys

import torch

from .. import _build
from . import flash_attention, ops

SHAPES = ((16, 14, 2, 64), (37, 14, 2, 64), (128, 14, 2, 64),
          (512, 14, 2, 64), (1024, 14, 2, 64), (2048, 14, 2, 64),
          (16, 32, 32, 128), (1024, 32, 32, 128))      # (T, H, KV, D)


def device_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn()`` from ``calls`` calls captured in a CUDA
    graph and replayed ``reps`` times (after warm-up calls)."""
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def sweep(t: int, h: int, kv: int, d: int, dtype, gen) -> str:
    q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, t, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, t, kv, d), generator=gen, device="cuda").to(dtype)
    pos = torch.arange(t, dtype=torch.int32, device="cuda")
    want = flash_attention(q, k, v, pos, pos)        # sets the limits too
    out = torch.empty_like(q)
    plan = ops.plan_flash(1, t, t, h, kv, d, dtype)
    launch = ops._lib()[0]
    step = max(16, plan.d_class // 8)
    cells = []
    for ks in ((1, 2) if plan.d_class == ops.SPLIT_CLASS else (1,)):
        for rows in range(step, ops.MAX_ROWS + 1, step):
            smem = ops.smem_bytes(dtype, plan.d_class, rows,
                                  plan.n_key_tiles, ks)
            if rows * 2 * ks > ops.MAX_THREADS or smem > ops.SMEM_LIMIT \
                    or rows & (rows - 1):
                continue

            def call(rows=rows, ks=ks, smem=smem):
                _build.check(launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    pos.data_ptr(), pos.data_ptr(), out.data_ptr(), 1, t, t,
                    h, kv, d, 1, 0, _build.DTYPE_CODES[dtype], rows, ks,
                    smem, torch.cuda.current_stream().cuda_stream),
                    ops.NAME)

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want) and (rows, ks) == (plan.rows,
                                                             plan.key_groups):
                raise AssertionError("the plan's launch differs from the "
                                     "wrapper's")
            err = (out.float() - want.float()).abs().max().item()
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            if err > tol:
                raise AssertionError(f"rows={rows} ks={ks}: error {err}")
            mark = "*" if (rows, ks) == (plan.rows, plan.key_groups) else ""
            cells.append(f"{rows}x{ks}{mark} {device_ms(call):.5f}")
    return (f"[sweep] flash_attention T={t} H={h} KV={kv} D={d} "
            f"{str(dtype)[6:]} (rows x key groups, ms; * = plan_flash): "
            + ", ".join(cells))


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep: no CUDA device available", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            print(sweep(*shape, dtype, gen), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
