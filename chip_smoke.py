#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (one NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each raising on its first fault
(the script exits 0 only if every phase passed):

  1. build   compile every CUDA kernel of the port from its ``csrc/``
             sources, one nvcc per kernel, all started together.
  2. kernels hold each kernel against its plain PyTorch version on the card,
             in float32 and bfloat16, at the serving shapes and around
             them; time the kernel, the plain version and
             ``scaled_dot_product_attention`` (a yardstick the port never
             calls) from CUDA-graph replays.
  3. serve   full-width qwen2-0.5b with random weights from a seed:
             ``measure_cost_model``, then ``PreemptiveServingEngine`` with
             4 slices x 4 units serving 24 requests in a 2:1 HP:LP mix.
             Checks every HP request done, every done LP request holding
             its tokens, both kernels launched; then holds the card's
             prefill and decode logits for one prompt against the plain
             path on the CPU.

The last lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.task import Priority
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import model as M
from repro_torch.serving.cost_model import measure_cost_model
from repro_torch.serving.engine import (PreemptiveServingEngine,
                                        ServeRequest, engine_network_config)
from repro_torch.training.steps import make_prefill_step, make_serve_step

# H100 SXM, NVIDIA data sheet: HBM rate and dense peaks by input type (f32
# outside the tensor cores; the kernels do their arithmetic there).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Tolerances of the repo's kernel tests (tests/test_kernels.py TOLS): f32
# differs only in summation order; bf16 outputs round to 8 mantissa bits.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Full-width logits, card vs CPU: 24 f32 layers whose matrix products sum
# in another order in cuBLAS than in the CPU's BLAS.
LOGIT_TOL = 2e-4

ARCH = "qwen2-0.5b"
B, H, KV, D = 1, 14, 2, 64            # qwen2-0.5b attention at batch 1
CACHE_LEN = 256                       # the engine's default
PROMPT_LEN = 16                       # as examples/preemptive_serving.py
LP_TOKENS = 24
N_REQUESTS = 24


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times between two events (no host gaps between
    launches; inputs stay in L2 between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
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


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: int, flops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------------- #
# Phase 1: build                                                              #
# --------------------------------------------------------------------------- #


def phase_build() -> None:
    names = _build.all_kernels()
    t0 = time.perf_counter()
    logs = _build.build(names)
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(names)} kernels {names} ready in {dt:.2f} s "
          f"(built now: {sorted(logs)})")


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions                               #
# --------------------------------------------------------------------------- #


def _decode_case(s: int, n_filled: int, pos: int, window: int, dtype,
                 gen) -> tuple:
    """q [B,H,D], cache [B,S,KV,D] and its slot positions.  A rotating
    cache (window > 0) holds, in slot j, the newest position p <= pos with
    p % S == j; a contiguous one holds 0..n_filled-1 and then -1."""
    q = torch.randn((B, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, s, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, s, KV, D), generator=gen, device="cuda").to(dtype)
    if window > 0:
        slots = torch.arange(s, device="cuda")
        row = pos - ((pos - slots) % s)
    else:
        row = torch.arange(s, device="cuda")
        row = torch.where(row < n_filled, row, torch.full_like(row, -1))
    positions = row.to(torch.int32)[None].expand(B, s).contiguous()
    return q, k, v, positions, pos, window


def _flash_case(t: int, dtype, gen) -> tuple:
    q = torch.randn((B, t, H, D), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, t, KV, D), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, t, KV, D), generator=gen, device="cuda").to(dtype)
    p = torch.arange(t, dtype=torch.int32, device="cuda")
    return q, k, v, p, p


def _check(name: str, label: str, got, want, dtype) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {label}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    print(f"[kernels] {name} {label} {str(dtype)[6:]}: max_abs_err={err:.3g} "
          f"(tol {TOL[dtype]:g})")
    if err > TOL[dtype]:
        raise AssertionError(f"{name} {label}: error {err} > {TOL[dtype]}")
    return err


DECODE_ROW = {"name": "decode_attention", "route": "cuda",
              "source": "repro_torch/kernels/decode_attention/csrc/"
                        "decode_attention.cu",
              "replaces": "src/repro/kernels/decode_attention/kernel.py:64"}
FLASH_ROW = {"name": "flash_attention", "route": "cuda",
             "source": "repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:66"}


def phase_kernels() -> dict:
    """Check and time every case; returns per kernel the numbers of its
    main-path case (float32)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # decode: the engine's cache (S=256) with a served request's 40
    # positions, a ragged S, and a rotating window cache
    decode_cases = [("S=256 filled=40 (main path)", 256, 40, 39, 0),
                    ("S=200 filled=200", 200, 200, 199, 0),
                    ("S=64 window=64 rotated pos=300", 64, 0, 300, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, s, n_filled, pos, window) in enumerate(decode_cases):
            args = _decode_case(s, n_filled, pos, window, dtype, gen)
            want = decode_attention_ref(*args[:5], window=window)
            got = decode_attention(*args[:5], window=window)
            err = _check("decode_attention", label, got, want, dtype)
            timing = _time_decode(label, args)
            if i == 0 and dtype == torch.float32:
                rows["decode_attention"] = dict(DECODE_ROW, max_abs_err=err,
                                                **timing)

    flash_cases = [(f"T={t} causal", t, True, 0) for t in (8, 16, 37, 128)]
    flash_cases += [("T=128 causal window=32", 128, True, 32),
                    ("T=37 non-causal", 37, False, 0)]
    for dtype in (torch.float32, torch.bfloat16):
        for label, t, causal, window in flash_cases:
            args = _flash_case(t, dtype, gen)
            want = flash_attention_ref(*args, causal=causal, window=window)
            got = flash_attention(*args, causal=causal, window=window)
            err = _check("flash_attention", label, got, want, dtype)
            timing = _time_flash(label, args, causal, window)
            if t == PROMPT_LEN and dtype == torch.float32:
                rows["flash_attention"] = dict(FLASH_ROW, max_abs_err=err,
                                               **timing)
    return rows


def _report(name: str, label: str, dtype, ms: float, plain: float,
            lib: float, n_bytes: int, flops: float) -> dict:
    bms, by = bound_ms(n_bytes, flops, dtype)
    print(f"[kernels] {name} {label} {str(dtype)[6:]}: kernel_ms={ms:.5f} "
          f"plain_ms={plain:.5f} library_ms={lib:.5f} bound_ms={bms:.6f} "
          f"({by})")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by}


def _time_decode(label: str, args) -> dict:
    q, k, v, positions, pos, window = args
    valid = (positions >= 0) & (positions <= pos)
    if window > 0:
        valid &= positions > pos - window
    n_valid = int(valid.sum())
    mask = valid[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda: decode_attention(q, k, v, positions, pos,
                                            window=window))
    plain = device_ms(lambda: decode_attention_ref(q, k, v, positions, pos,
                                                   window=window))
    lib = device_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                 enable_gqa=True))
    # each input once (only the valid K/V rows are needed), output once
    kv_row = KV * D * k.element_size()
    n_bytes = _nbytes(q, positions) + 2 * n_valid * kv_row + _nbytes(q)
    return _report("decode_attention", label, q.dtype, ms, plain, lib,
                   n_bytes, 4.0 * H * D * n_valid)


def _time_flash(label: str, args, causal: bool, window: int) -> dict:
    q, k, v, qp, kp = args
    mask = None
    n_pairs = B * qp.shape[0] * kp.shape[0]
    if causal:
        mask = kp[None, :] <= qp[:, None]
        if window > 0:
            mask &= kp[None, :] > qp[:, None] - window
        n_pairs = B * int(mask.sum())
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = device_ms(lambda: flash_attention(q, k, v, qp, kp, causal=causal,
                                           window=window))
    plain = device_ms(lambda: flash_attention_ref(q, k, v, qp, kp,
                                                  causal=causal,
                                                  window=window))
    lib = device_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                 enable_gqa=True))
    n_bytes = _nbytes(q, k, v, qp, kp) + _nbytes(q)
    return _report("flash_attention", label, q.dtype, ms, plain, lib,
                   n_bytes, 4.0 * H * D * n_pairs)


# --------------------------------------------------------------------------- #
# Phase 3: serve full-width qwen2-0.5b                                        #
# --------------------------------------------------------------------------- #


def phase_serve() -> dict[str, int]:
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"[serve] {ARCH}: {cfg.n_layers} layers d={cfg.d_model} "
          f"H={cfg.n_heads} KV={cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.padded_vocab}, {n_params} params "
          f"({cfg.param_dtype}) initialised in "
          f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cost = measure_cost_model(cfg, prompt_len=PROMPT_LEN,
                              cache_len=CACHE_LEN, reps=3, device="cuda")
    print(f"[serve] cost model in {time.perf_counter() - t0:.2f} s: "
          f"prefill {cost.prefill[1]}, decode {cost.decode}")
    _step_device_times(cfg, params, cost, n_params)
    net = engine_network_config(cost, LP_TOKENS)
    eng = PreemptiveServingEngine(cfg, params, cost, device="cuda",
                                  n_slices=4, units_per_slice=4,
                                  preemption=True, lose_work=True, net=net)

    gen = torch.Generator()
    gen.manual_seed(1)
    hp_deadline = net.t_hp * 2.0 + 0.05
    lp_exec = cost.lp_exec_time(2, LP_TOKENS)
    reqs = []
    for i in range(N_REQUESTS):
        prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                               generator=gen)
        hp = i % 3 != 2                       # 2:1 interactive:batch mix
        arrive = 0.02 * i
        req = ServeRequest(
            prompt=prompt,
            max_new_tokens=2 if hp else LP_TOKENS,
            priority=Priority.HIGH if hp else Priority.LOW,
            deadline=arrive + (hp_deadline if hp else lp_exec * 3.0),
            home_slice=i % 4)
        reqs.append(req)
        eng.q.push(arrive, lambda r=req: eng.submit(r))

    decode_attention.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    m = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}

    hp_reqs = [r for r in reqs if r.priority == Priority.HIGH]
    lp_done = [r for r in reqs
               if r.priority == Priority.LOW and r.state == "done"]
    print(f"[serve] engine run {wall:.2f} s wall: HP "
          f"{sum(r.state == 'done' for r in hp_reqs)}/{len(hp_reqs)} done, "
          f"LP {len(lp_done)}/{len(reqs) - len(hp_reqs)} done, "
          f"{m.preemptions} preemptions, {m.realloc_success} victim "
          f"reallocations, {m.lp_offloaded} LP offloaded")
    print("[serve] summary " + json.dumps(m.summary(), default=str))
    print("[serve] kernel launches in the engine run: " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    bad_hp = [(r.rid, r.state) for r in hp_reqs if r.state != "done"]
    if bad_hp:
        raise AssertionError(f"HP requests not done: {bad_hp}")
    for r in lp_done:
        if len(r.tokens_out) != r.max_new_tokens:
            raise AssertionError(f"LP request {r.rid} holds "
                                 f"{len(r.tokens_out)} tokens")
    for r in reqs:
        if not all(0 <= t < cfg.vocab_size for t in r.tokens_out):
            raise AssertionError(f"request {r.rid}: token out of range")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched")

    _check_against_cpu(cfg, params, reqs[0].prompt)
    return launches


def _step_device_times(cfg, params, cost, n_params: int) -> None:
    """Device time of one prefill and one decode step from CUDA-graph
    replay (no host gaps), beside the host-fenced times the cost model
    measured at the same shapes (degree 2 is the measured decode time):
    the gap is host dispatch, during which the device idles."""
    pre = make_prefill_step(cfg, CACHE_LEN, device="cuda")
    srv = make_serve_step(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                                     generator=gen, device="cuda")}
    nxt, caches = pre(params, batch)
    last = nxt[:, None]
    steps = (("prefill", cost.prefill[1].mean_s,
              device_ms(lambda: pre(params, batch), calls=3, reps=3)),
             ("decode", cost.decode[2].mean_s,
              device_ms(lambda: srv(params, caches, last, PROMPT_LEN),
                        calls=3, reps=3)))
    weights_ms = 1e3 * 4 * n_params / HBM_BYTES_PER_S
    for name, host_s, dev_ms in steps:
        print(f"[serve] {name} step T={PROMPT_LEN}: host-fenced "
              f"{1e3 * host_s:.3f} ms, device {dev_ms:.3f} ms "
              f"(graph replay), device idle share "
              f"{1 - dev_ms / (1e3 * host_s):.3f}; weights read once "
              f"{weights_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@torch.inference_mode()
def _check_against_cpu(cfg, params, prompt) -> None:
    """Prefill and one decode step on the card (kernels) and on the CPU
    (plain versions) from the same weights and prompt."""
    logits = {}
    for dev, p in (("cuda", params), ("cpu", _tree_to(params, "cpu"))):
        pre, caches = M.prefill(p, cfg, {"tokens": prompt.to(dev)},
                                CACHE_LEN)
        nxt = prompt[:, -1:].to(dev)
        dec, _ = M.decode_step(p, cfg, caches, nxt, prompt.shape[1])
        logits[dev] = (pre.float().cpu(), dec.float().cpu())
    for i, phase in enumerate(("prefill", "decode")):
        got, want = logits["cuda"][i], logits["cpu"][i]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{phase} logits not finite")
        err = (got - want).abs().max().item()
        print(f"[serve] {phase} logits [1, 1, {got.shape[-1]}] card vs CPU: "
              f"max_abs_err={err:.3g} (tol {LOGIT_TOL:g}, logits "
              f"max |x|={want.abs().max().item():.3g})")
        if err > LOGIT_TOL:
            raise AssertionError(f"{phase} logits differ by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    print(f"[env] card: {card}")
    phase_build()
    rows = phase_kernels()
    launches = phase_serve()
    kernels = [dict(rows[name], launches=launches[name])
               for name in sorted(rows)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
