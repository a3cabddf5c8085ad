#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (one NVIDIA H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It runs every phase, each raising on its
first fault (the script exits 0 only if every phase passed):

  1. build   compile every CUDA kernel of the port from its ``csrc/``
             sources, one nvcc per kernel, all started together; count
             the tensor-core instructions in the halo conv and flash
             attention libraries' SASS (``cuobjdump -sass``; none is a
             failure).
  2. kernels hold each kernel against its plain PyTorch version on the card,
             in float32 and bfloat16, at the serving shapes and around
             them; time the kernel, the plain version and a library call
             where one exists (``scaled_dot_product_attention`` for the
             attention kernels, a cuDNN ``conv2d`` chain for the halo conv
             block; yardsticks the port never calls) from CUDA-graph
             replays; both attention kernels and SDPA also with L2
             flushed.  The decode kernel also runs at the edges of its
             chunking (an empty cache, S=1, S=4096, other head dims), at
             the heads of every model below, and at the serving cells'
             decode with the position as a 0-d int32 tensor on the card
             (bit-equal to the launch at a host int and timed beside it;
             the kernels line's ``main_path``), its counters checked back
             at 0 after every graph replay.  The flash kernel also runs at
             T=1024, at deepseek-7b's heads (H = KV = 32, D = 128),
             phi3-mini's (D = 96), llava-next-34b's over its 2896-token
             prompt (H=56, KV=8, D=128), seamless's unmasked at T=16 and
             T=1 over 16 frames (its cross-attention), at positions that
             do not start at 0, with keys in a random order of positions,
             at D=48, and at MLA's expanded prefill (H = KV = 128, D=192,
             V zero-padded) at T=16 and T=1024, and prints its plan and how
             many K tiles it visits.  The sLSTM scan prints
             its plan and how many of its clusters fit on the card, is
             timed with L2 flushed too, runs 200 decode steps in place
             against the plain version, and must give bit-identical
             results with 16 and 8 CTAs a cluster.  The halo conv block
             runs at YoloV2's widths and on a small block with ragged
             channel counts, and is also checked for tiling invariance
             (its standalone phase); its bound counts the bf16
             tensor-core passes its split operands take.  The sLSTM
             backward kernel runs at xLSTM's heads (H=4, dh=512) at T=1,
             16, 1024 and 4096 (the train step's), at B=2 from a given
             state with the final state's gradients, and at a ragged
             dh=48, f32 and bf16: the forward's saving mode and the
             backward against their plain versions (each tensor relative
             to its largest magnitude), two runs and 16 vs 8 CTAs a
             cluster bit-identical; at T >= 1024 timed beside the plain
             backward, the forward's saving mode and its bound, and the
             backward launch alone (profiler).  Beside each kernel's cases,
             its model-layout adapter (``cached_decode_attention`` at the
             serving shape, S=200 and a window of 64; ``mha_attention`` at
             phi3-mini's heads, T=16 and 200, causal, windowed and
             unmasked, and one backward; ``slstm_hidden_states`` at
             xLSTM's, T=16 and 200) in f32 and bf16: bit-equal to the
             wrapper call it wraps, within the kernel's tolerance of the
             plain version, one launch a call, both timed.
  3. serve   for each served model with random weights from seed 0 (full
             width; qwen2-0.5b, phi3-mini-3.8b and xlstm-1.3b whole, then
             deepseek-v2-236b cut to its dense layer and two MoE layers):
             ``measure_cost_model`` (its weights freed before the served
             ones are made), then ``PreemptiveServingEngine`` with 4 slices
             x 4 units serving 24 requests in a 2:1 HP:LP mix.  Checks
             every HP request done, every done LP request holding its
             tokens, each kernel of the model launched from the host
             exactly once per layer per prefill or decode token that was
             not replayed from the serving steps' CUDA graphs (a replayed
             step's kernels are counted by the profiler in one replay,
             and the kernels line gives them apart as
             ``replayed_launches``), and peak device memory under 80 GB;
             then holds the card's prefill and decode logits against the
             plain path (qwen2 and phi3 decoding at positions held on the
             card, as their decode graph does; the attention and MLA
             models: the CPU,
             deepseek-v2 at one dense + one MoE layer, with the smallest
             gap between a token's k-th and (k+1)-th router score; xLSTM:
             the full model with the sLSTM plain version swapped in on the
             card, and one full-width superblock on the CPU).  Before the
             engine run it times one prefill and one decode step by
             CUDA-graph replay and records one of each under
             ``torch.profiler``, printing the kernels that take the most
             device time.
     churn   full-width qwen2-0.5b serves the same mix on 4 slices: once
             as above, recording its slots (and, at each LP slot's
             midpoint, which slices have room), then with slices failing,
             draining and rejoining at times placed on the recorded
             timelines: the slice of the first HP request fails while the
             request is reserved there and rejoins an HP slot later (a run
             with this failure alone records the timeline the rest is
             placed on); later the slice running an LP decode (its home
             slice where one has room) fails at the decode's midpoint, a
             third slice drains, and the failed slice rejoins.  Orphans
             restart their prefill (flash) and decode (decode attention)
             elsewhere.  Checks every request settled, HP requests done or
             counted as failed admissions, orphans created (at least 2)
             and recovered (at least 1), re-placed requests' tokens equal
             to the first run's, launches exact with the restarts, the
             decode kernel's counters at rest, and the engine's device
             memory freed once it is dropped.
     sim     the port's host runtimes on this machine's Python: the
             paper's testbed scenarios (UPS, UNPS, WPS_4, WNPS_4, DPW,
             DNPW, CPW, CNPW) at 1296 frames, each equal to the JAX
             package's numbers; the chaos scenarios smoke and churn_mixed
             and the degrade storm's smoke with their gates; 20,000
             firehose requests through ``StreamingEngine`` on 64 devices,
             every task settled and the RSS flat.
  4. model   the models the engine does not serve (it passes tokens only):
             deepseek-7b, seamless-m4t-medium (12 encoder + 12
             cross-attending decoder layers over 16 frames), llava-next-34b
             (2880 patches before the prompt; 12 of its 60 layers, all 60 do
             not fit one card in f32), deepseek-v3-671b (its dense layer and
             one MoE layer: sigmoid router, q-LoRA) and jamba-1.5-large-398b
             (layers 2-3 of its superblock: Mamba + dense FFN, attention +
             MoE), each at full width: the cost model, the step device
             times at the model's real positions with their ``[profile]``
             lines, and one prefill with 8 decode tokens, whose kernel
             launches must be exact and whose logits are held against both
             kernels' plain versions on the card and against the CPU
             (llava: at one layer and 64 patches; deepseek-v3: its dense
             layer; jamba: its Mamba layer).
  5. train   full-width qwen2-0.5b in f32 from seed 0 trains 3 AdamW steps
             (lr 1e-3, warmup 1, 8 total) on the synthetic Zipf stream at
             T=4096 (the train_4k shape) and batch 1 (cut from 256), each
             layer recomputed in the backward: loss and gradient norm
             finite, exactly 48 flash forward and 24 flash backward
             launches a step, step times and tokens/s, peak device
             memory; the gradients after step 1 against the same step
             with the flash forward and backward's plain versions on the
             card; a checkpoint of params and optimizer state after step
             2, restored into fresh tensors, from which step 3 must give
             the live run's state bit for bit; 8 greedy tokens decoded
             from the restored weights (launches exact, logits against
             the plain attention); a ``[profile]`` breakdown of one step
             (flash forward, each backward launch, cuBLAS, elementwise,
             the optimizer); then 2 full-width layers at T=256 against
             the CPU (loss, every gradient leaf, the updated params).
             The kernels phase also holds the backward kernel against its
             plain version (f32 and bf16, qwen2's heads at T=16, 1024 and
             4096, deepseek-7b's at 1024, phi3-mini's D=96, MLA's D=192
             at 16 and 1024 and one MLA head at 14000, a window,
             seamless's T=1 cross-attention, positions from 100) and times
             it beside the backward of ``scaled_dot_product_attention``,
             with the bound of its tensor-core scheme (f32 as six bf16
             passes) beside the f32 bound, and at T=4096 each of its
             three launches' device time; ``[build]`` gives every backward
             instance's dynamic shared memory, and the train step's
             ``[profile]`` the backward's share of the step.
             Then the whole full-width xlstm-1.3b in f32 from seed 0 trains
             2 AdamW steps at the same shape (one superblock recomputed a
             repeat): the sLSTM scan twice (saving mode) and its backward
             kernel once a sLSTM layer a step, no flash; loss and gradient
             norm finite, ms and tokens/s a step, peak device memory under
             80 GB, a ``[profile]`` of a third step.  Checks that need a
             second copy of the state run at one full-width superblock (7
             mLSTM + 1 sLSTM): its gradients twice, bit-identical, and
             against the sLSTM plain forward and backward on the card;
             then 1 mLSTM + 1 sLSTM layer at T=256 against the CPU.

The last lines are the card's name and power limit, one JSON object
describing each kernel, and ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import weakref
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.data import train_batches
from repro_torch.core.network import NetworkConfig
from repro_torch.core.profiles import TaskProfile, WorkloadSpec
from repro_torch.core.task import Priority, reset_id_counters
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (cached_decode_attention,
                                                  decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_ref,
                                                 flash_attention_ref,
                                                 mha_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.halo_conv2d import (conv_block_ref,
                                             halo_conv_block,
                                             halo_conv_block_tiles,
                                             halo_conv_block_tiles_ref)
from repro_torch.kernels.halo_conv2d.ops import _extract_tiles, plan_block
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan import phases as slstm_phases
from repro_torch.kernels.slstm_scan.ref import param_grads
from repro_torch.kernels.slstm_scan import (slstm_hidden_states,
                                            slstm_scan, slstm_scan_bwd,
                                            slstm_scan_bwd_ref,
                                            slstm_scan_ref,
                                            slstm_scan_saving,
                                            slstm_scan_saving_ref)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.head_padding import pad_attn_params, \
    pad_heads_config
from repro_torch.models.config import StageDef
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import ffn as FF
from repro_torch.models.layers import mla as L
from repro_torch.models.layers import xlstm as X
from repro_torch.serving.cost_model import measure_cost_model
from repro_torch.serving.engine import (PreemptiveServingEngine,
                                        ServeRequest, engine_network_config)
from repro_torch.serving.stream import StreamingEngine
from repro_torch.sim import (CHAOS_SCENARIOS, SCENARIOS, FirehoseConfig,
                             chaos_gate, firehose, run_chaos, run_scenario)
from repro_torch.sim import degrade_storm as storm
from repro_torch.training import graphs
from repro_torch.training import steps as TS
from repro_torch.training.optimizer import AdamWConfig, tree_leaves
from repro_torch.training.steps import (init_train_state, loss_and_grads,
                                        make_prefill_step, make_serve_step,
                                        make_train_step)

# H100 SXM, NVIDIA data sheet: HBM rate and dense peaks by input type (f32
# outside the tensor cores, where the attention and sLSTM kernels do their
# arithmetic; the halo conv kernel issues bf16 tensor-core products, so its
# bound counts its split passes at the bf16 peak in either dtype).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# The flash backward's products on the tensor cores: bf16 at its peak, f32
# as six bf16 passes a product.
TC_PEAK_FLOPS = {torch.float32: 989e12 / 6, torch.bfloat16: 989e12}
# Tolerances of the repo's kernel tests (tests/test_kernels.py TOLS): f32
# differs only in summation order; bf16 outputs round to 8 mantissa bits.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# Halo conv block against the cuDNN block on the whole image, relative to
# the output's largest magnitude: the reference's own 1e-4
# (tests/test_kernels.py) in f32, 8 mantissa bits in bf16, where cuDNN
# rounds between layers.  Against its plain version, which like the kernel
# sums in f32 and rounds once, the kernel holds to f32 summation order
# (HALO_F32_TOL x max|y|) plus, in bf16, that one rounding (half an ulp,
# at most 2^-8 |y|, of each element).  Tiling invariance is exact.
HALO_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
HALO_F32_TOL = 1e-5
HALO_ROUND = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
# Full-width logits, card vs CPU: f32 layers whose matrix products sum
# in another order in cuBLAS than in the CPU's BLAS.
LOGIT_TOL = 2e-4

# A cut keeps full-width layers of a model: ((stage, pattern slots,
# repeats), ...) of its stages, in order (:func:`_cut`).  The card-vs-CPU
# check of a cut model runs at a smaller cut of the cut, whose weights are
# views of the card's (:func:`_sub`).
V2_CUT = ((0, (0,), 1), (1, (0,), 2))     # deepseek-v2: 1 dense + 2 MoE
V3_CUT = ((0, (0,), 1), (1, (0,), 1))     # deepseek-v3: 1 dense + 1 MoE
JAMBA_CUT = ((0, (2, 3), 1),)             # jamba: mamba+dense, attn+moe
FIRST_LAYER = ((0, (0,), 1),)
# served: arch, cut (None: whole), cut of the card-vs-CPU check
SERVED = (("qwen2-0.5b", None, None),
          ("phi3-mini-3.8b", None, None),
          ("xlstm-1.3b", None, None),
          ("deepseek-v2-236b", V2_CUT, ((0, (0,), 1), (1, (0,), 1))))
# leaves of the JAX trees at these cuts (eval_shape of its init_params)
JAX_PARAMS = {"xlstm-1.3b": 3_503_728_976,
              "deepseek-v2-236b": 9_330_795_520,
              "deepseek-v3-671b": 13_947_804_672,
              "jamba-1.5-large-398b": 11_912_896_512}
CARD_BYTES = 80e9                     # an H100's 80 GB
B, H, KV, D = 1, 14, 2, 64            # qwen2-0.5b attention at batch 1
SH, SDH = 4, 512                      # xlstm-1.3b sLSTM heads, head dim
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


def _graph(fn, calls: int) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in a CUDA graph, after three
    warm-up calls on a side stream."""
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
    return graph


def device_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times between two events (no host gaps between
    launches; inputs stay in L2 between calls)."""
    graph = _graph(fn, calls)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


FLUSH_BYTES = 256 * 2**20             # written before a cold call; L2 50 MB
_flush = []


def cold_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn()`` with L2 flushed, as a step's kernel meets
    its inputs: one call captured in a CUDA graph; before each replay a
    256 MiB buffer is written (which also keeps the device busy while the
    host enqueues the replay), and events bracket the replay alone."""
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, device="cuda"))
    buf = _flush[0]
    graph = _graph(fn, 1)
    events = []
    for _ in range(reps):
        buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound_ms(n_bytes: int, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# --------------------------------------------------------------------------- #
# Phase 1: build                                                              #
# --------------------------------------------------------------------------- #


TENSOR_CORE_KERNELS = ("halo_conv2d", "flash_attention")


def _instance(line: str) -> str:
    """A kernel template instance from ptxas's mangled entry name, as
    ``name<dtype, template ints>`` (flash: dtype, width class 0/1/2 for D
    up to 64/128/256, and the forward's key groups)."""
    found = re.search(r"_kernelI(.*?)EEv", line)
    if not found:
        return ""
    args = found.group(1).replace("13__nv_bfloat16", "bf16,")
    args = re.sub(r"^f", "f32,", args)
    args = re.sub(r"Li(\d+)E", r"\1,", args)
    name = re.search(r"\d+([a-z_]+_kernel)I", line)
    return f" {name.group(1) if name else ''}<{args.rstrip(',')}>"


def phase_build() -> None:
    names = _build.all_kernels()
    t0 = time.perf_counter()
    logs = _build.build(names)
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        instance = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                instance = _instance(line)
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}{instance}: {line.strip()}")
    print(f"[build] {len(names)} kernels {names} ready in {dt:.2f} s "
          f"(built now: {sorted(logs)})")
    for dtype in (torch.float32, torch.bfloat16):
        for c, d_class in enumerate(flash_ops.D_CLASSES):
            smem = flash_ops.bwd_smem_bytes(dtype, d_class, 0, 0, 0)
            plan = flash_ops.plan_flash_bwd(1, 16, 16, 1, 1, d_class, dtype)
            print(f"[build] flash_attention bwd_stats/dkdv/dq_kernel<"
                  f"{str(dtype)[6:]}, {c}>: dynamic smem {smem[0]} / "
                  f"{smem[1]} / {smem[2]} B and about 5 B a visit-list "
                  f"entry; threads {plan.threads}")
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (SDH, 1024):       # the 256- and the 512-thread build
            plan = slstm_ops.plan_scan(1, TRAIN_T, SH, dh, dtype,
                                       backward=True)
            cp = plan.threads // slstm_ops.SLICES
            ring = slstm_ops.BWD_STAGES * slstm_ops.BWD_RUNS * (cp + 4) * 4
            print(f"[build] slstm_scan slstm_bwd_kernel<{str(dtype)[6:]}, "
                  f"{plan.threads}, {plan.register_rows}, "
                  f"{0 if cp == 32 else 1}> at dh={dh}: dynamic smem "
                  f"{plan.smem_bytes} B (of which the ring of "
                  f"{slstm_ops.BWD_STAGES} steps' inputs {ring} B), "
                  f"{plan.n_cta} CTAs a cluster, R^T rows a subslice of "
                  f"{-(-dh // slstm_ops.BWD_SUBS)}: {plan.register_rows} "
                  f"in registers, {plan.rows_per_slice} in shared memory; "
                  f"{plan.streamed_rows} of dh streamed (registers and "
                  "spills: its ptxas lines above)")
    # the halo conv and flash kernels' products must be tensor-core
    # instructions
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"  # the toolkit's
    for name in TENSOR_CORE_KERNELS:
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.library_path(name))],
                              check=True, capture_output=True, text=True,
                              timeout=300).stdout
        mma = {op: sum(op in ln for ln in sass.splitlines())
               for op in ("HGMMA", "HMMA")}
        print(f"[build] {name} SASS: {mma['HGMMA']} HGMMA and "
              f"{mma['HMMA']} HMMA instructions (cuobjdump -sass)")
        if not mma["HGMMA"] + mma["HMMA"]:
            raise AssertionError(f"{name}: no tensor-core instruction in "
                                 "its SASS")


# --------------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions                               #
# --------------------------------------------------------------------------- #


def _decode_case(s: int, n_filled: int, pos: int, window: int, dtype, gen,
                 d: int = D, alternate: bool = False, h: int = H,
                 kv: int = KV) -> tuple:
    """q [B,h,d], cache [B,S,kv,d] and its slot positions.  A rotating
    cache (window > 0) holds, in slot j, the newest position p <= pos with
    p % S == j; a contiguous one holds 0..n_filled-1 and then -1, and with
    ``alternate`` only its odd slots (so a chunk's first slot is empty)."""
    q = torch.randn((B, h, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, s, kv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, s, kv, d), generator=gen, device="cuda").to(dtype)
    slots = torch.arange(s, device="cuda")
    if window > 0:
        row = pos - ((pos - slots) % s)
    else:
        keep = slots < n_filled
        if alternate:
            keep &= slots % 2 == 1
        row = torch.where(keep, slots, torch.full_like(slots, -1))
    positions = row.to(torch.int32)[None].expand(B, s).contiguous()
    return q, k, v, positions, pos, window


def _flash_case(t: int, dtype, gen, h: int = H, kv: int = KV, d: int = D,
                offset: int = 0, permuted: bool = False,
                s: int | None = None, v_dim: int | None = None) -> tuple:
    """A prompt of t tokens at positions offset..offset+t-1; with
    ``permuted`` the keys hold those positions in a random order.  With
    ``s``, t queries over s other keys at positions 0..s-1, as
    cross-attention gives them (unmasked).  With ``v_dim``, V's columns
    from v_dim on are zero (MLA's V padded to the query/key width)."""
    q = torch.randn((B, t, h, d), generator=gen, device="cuda").to(dtype)
    n_keys = t if s is None else s
    k = torch.randn((B, n_keys, kv, d), generator=gen,
                    device="cuda").to(dtype)
    v = torch.randn((B, n_keys, kv, d), generator=gen,
                    device="cuda").to(dtype)
    if v_dim is not None:
        v[..., v_dim:] = 0
    qp = offset + torch.arange(t, dtype=torch.int32, device="cuda")
    kp = qp if s is None else torch.arange(s, dtype=torch.int32,
                                           device="cuda")
    if permuted:
        kp = qp[torch.randperm(t, generator=gen, device="cuda")].contiguous()
    return q, k, v, qp, kp


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
# the flash kernel's backward has no TPU counterpart: the JAX train step
# differentiates the jnp attention
FLASH_BWD_ROW = {"name": "flash_attention_bwd", "route": "cuda",
                 "source": "repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention_bwd.cu",
                 "replaces": None}


def phase_kernels() -> dict:
    """Check and time every case; returns per kernel the numbers of its
    main-path case (float32)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    # the adapters' inputs come from a generator of their own, so the
    # kernels' cases keep theirs
    agen = torch.Generator(device="cuda")
    agen.manual_seed(1)
    rows = {"decode_attention": _decode_cases(gen)}
    t_adapters = _timed(_decode_adapter_cases, agen)
    rows["flash_attention"] = _flash_cases(gen)
    t_adapters += _timed(_mha_adapter_cases, agen)
    rows["flash_attention_bwd"] = _flash_bwd_cases(gen)
    rows["slstm_scan"] = _slstm_cases(gen)
    t_adapters += _timed(_slstm_adapter_cases, agen)
    rows["slstm_scan_bwd"] = _slstm_bwd_cases(gen)
    rows["halo_conv2d"] = _halo_cases(gen)
    print(f"[time] adapter cases: {t_adapters:.1f} s")
    return rows


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def _one_launch(name: str, label: str, counted, fn):
    """``fn()``, which must add exactly one to ``counted.launches``."""
    before = counted.launches
    out = fn()
    torch.cuda.synchronize()
    if counted.launches - before != 1:
        raise AssertionError(f"{name} {label}: "
                             f"{counted.launches - before} launches counted "
                             "for one call, not 1")
    return out


def _adapter_case(name: str, label: str, dtype, counted, adapter, direct,
                  plain, as_direct=lambda out: out) -> None:
    """A model-layout adapter against the wrapper call it wraps (bit-equal,
    ``as_direct`` taking its output to the wrapper's layout), its plain
    version (the kernel's tolerance) and its launches (one a call); then
    both calls' device ms by CUDA-graph replay."""
    got = _one_launch(name, label, counted, adapter)
    want = _one_launch(name, label, counted, direct)
    if not torch.equal(as_direct(got), want):
        raise AssertionError(f"{name} {label}: adapter differs from the "
                             "direct call")
    _check(name, label, as_direct(got), plain(), dtype)
    ms, direct_ms = device_ms(adapter), device_ms(direct)
    print(f"[kernels] {name} {label} {str(dtype)[6:]}: bit-equal to the "
          f"direct call, 1 launch a call; adapter_ms={ms:.5f} "
          f"direct_ms={direct_ms:.5f}")


def _decode_adapter_cases(gen) -> None:
    """``cached_decode_attention`` (q [B, 1, H, D]) at the serving shape,
    at S=200 (where the JAX adapter takes its oracle: S % 128 != 0) and
    with a window of 64 over the rotating 256-slot cache."""
    cases = [("S=256 filled=40 (serving)", 256, 40, 39, 0),
             ("S=200 filled=200", 200, 200, 199, 0),
             ("S=256 window=64 rotated pos=300", 256, 0, 300, 64)]
    for dtype in (torch.float32, torch.bfloat16):
        for label, s, n_filled, pos, window in cases:
            q, k, v, positions, pos, window = _decode_case(
                s, n_filled, pos, window, dtype, gen)
            q4 = q[:, None]
            _adapter_case(
                "cached_decode_attention", label, dtype, decode_attention,
                lambda: cached_decode_attention(q4, k, v, positions, pos,
                                                window=window),
                lambda: decode_attention(q, k, v, positions, pos,
                                         window=window),
                lambda: decode_attention_ref(q, k, v, positions, pos,
                                             window=window),
                as_direct=lambda out: out[:, 0])
            _counters_at_rest(f"cached_decode_attention {label}")


def _mha_adapter_cases(gen) -> None:
    """``mha_attention`` at phi3-mini's heads (H = KV = 32, D = 96), T=16
    and T=200 (where the JAX adapter takes its oracle: T % bq != 0),
    causal, windowed (64) and unmasked; then one backward through the
    adapter against the direct ``FlashAttentionFn`` gradients (bit-equal)
    and the plain backward."""
    phi3 = dict(h=32, kv=32, d=96)
    for dtype in (torch.float32, torch.bfloat16):
        for t in (16, 200):
            q, k, v, p, _ = _flash_case(t, dtype, gen, **phi3)
            for mask, causal, window in (("causal", True, 0),
                                         ("window=64", True, 64),
                                         ("unmasked", False, 0)):
                _adapter_case(
                    "mha_attention", f"phi3-mini heads T={t} {mask}", dtype,
                    flash_attention,
                    lambda: mha_attention(q, k, v, causal=causal,
                                          window=window),
                    lambda: flash_attention(q, k, v, p, p, causal=causal,
                                            window=window),
                    lambda: flash_attention_ref(q, k, v, p, p,
                                                causal=causal,
                                                window=window))
    label = "phi3-mini heads T=200 causal backward"
    q, k, v, p, _ = _flash_case(200, torch.float32, gen, **phi3)
    d_out = torch.randn(q.shape, generator=gen, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = _one_launch("mha_attention", label, flash_attention,
                      lambda: mha_attention(*leaves))
    got = _one_launch("mha_attention", label, flash_attention_bwd,
                      lambda: torch.autograd.grad(out, leaves, d_out))
    out_direct = FlashAttentionFn.apply(*leaves, p, p, True, 0)
    want = torch.autograd.grad(out_direct, leaves, d_out)
    if not torch.equal(out, out_direct) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"mha_attention {label}: gradients differ "
                             "from the direct FlashAttentionFn call")
    plain = flash_attention_bwd_ref(q, k, v, p, p, out.detach(), d_out)
    _rel_check("mha_attention", label, ("dq", "dk", "dv"), got, plain,
               torch.float32)
    print(f"[kernels] mha_attention {label} float32: dq, dk, dv bit-equal "
          "to the direct FlashAttentionFn call, 1 forward + 1 backward "
          "launch")


def _slstm_adapter_cases(gen) -> None:
    """``slstm_hidden_states`` at xLSTM's sLSTM (B=1, H=4, dh=512) from the
    zero state, T=16 and T=200."""
    for dtype in (torch.float32, torch.bfloat16):
        for t in (16, 200):
            wx, r, bias, _ = _slstm_inputs(1, t, False, dtype, gen)
            _adapter_case(
                "slstm_hidden_states", f"B=1 T={t} zero state", dtype,
                slstm_scan, lambda: slstm_hidden_states(wx, r, bias),
                lambda: slstm_scan(wx, r, bias)[0],
                lambda: slstm_scan_ref(wx, r, bias)[0])


def _report(name: str, label: str, dtype, ms: float, plain: float,
            lib: float | None, n_bytes: int, flops: float,
            peak: float | None = None) -> dict:
    bms, by = bound_ms(n_bytes, flops, peak or PEAK_FLOPS[dtype])
    lib_s = "none" if lib is None else f"{lib:.5f}"
    print(f"[kernels] {name} {label} {str(dtype)[6:]}: kernel_ms={ms:.5f} "
          f"plain_ms={plain:.5f} library_ms={lib_s} bound_ms={bms:.6f} "
          f"({by})")
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by}


def _counters_at_rest(where: str) -> None:
    """The decode kernel's CTAs meet on counters that every call must leave
    at 0 (what lets a CUDA graph replay it)."""
    torch.cuda.synchronize()
    for dev, t in decode_ops._counters.items():
        if int(t.count_nonzero()):
            raise AssertionError(f"decode_attention counters on cuda:{dev} "
                                 f"not back at 0 after {where}")


def _decode_cases(gen) -> dict:
    """The engine's cache (S=256) with a served request's 40 positions,
    then around it: a ragged S, a rotating window cache, an empty cache
    (exact zeros), S=1, a long cache (many chunks, a ragged last one),
    valid slots alternating with empty ones, D=128, head dims that take
    the kernel's scalar loads (D=60 in bf16, D=63), and the heads of the
    other served and run models (phi3-mini H=KV=32 D=96, deepseek-7b
    H=KV=32 D=128, llava-next-34b H=56 KV=8 D=128, seamless H=KV=16 D=64,
    jamba H=64 KV=8 D=128; MLA's absorbed decode runs no kernel).
    Each case is checked again after its CUDA-graph timing replays."""
    phi3, deepseek = dict(h=32, kv=32, d=96), dict(h=32, kv=32, d=128)
    llava, seamless = dict(h=56, kv=8, d=128), dict(h=16, kv=16, d=64)
    jamba = dict(h=64, kv=8, d=128)
    cases = [("S=256 filled=40 (main path)", 256, 40, 39, 0, {}, False),
             ("S=200 filled=200", 200, 200, 199, 0, {}, False),
             ("S=64 window=64 rotated pos=300", 64, 0, 300, 64, {}, False),
             ("S=256 empty", 256, 0, 39, 0, {}, False),
             ("S=1", 1, 1, 0, 0, {}, False),
             ("S=4096 filled=3000", 4096, 3000, 2999, 0, {}, False),
             ("S=256 filled=200 odd slots only", 256, 200, 199, 0, {}, True),
             ("S=256 filled=40 D=128", 256, 40, 39, 0, dict(d=128), False),
             ("S=256 filled=40 D=60", 256, 40, 39, 0, dict(d=60), False),
             ("S=256 filled=40 D=63", 256, 40, 39, 0, dict(d=63), False),
             ("phi3-mini heads S=256 filled=40", 256, 40, 39, 0, phi3,
              False),
             ("deepseek-7b heads S=256 filled=40", 256, 40, 39, 0, deepseek,
              False),
             ("llava heads S=256 filled=40", 256, 40, 39, 0, llava, False),
             ("llava heads S=3136 filled=2897 (its decode at 2896)", 3136,
              2897, 2896, 0, llava, False),
             ("seamless heads S=256 filled=40", 256, 40, 39, 0, seamless,
              False),
             ("jamba heads S=256 filled=40", 256, 40, 39, 0, jamba, False)]
    plan = decode_ops.plan_split(B, CACHE_LEN, H, KV, D)
    smem = _build.load("decode_attention").decode_attention_smem_bytes(
        H, KV, D, plan.chunk, 0)
    print(f"[kernels] decode_attention main path: grid {plan.grid} of "
          f"{plan.chunk}-slot chunks, {smem} bytes of dynamic shared memory "
          "a CTA (f32)")
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, s, n_filled, pos, window, shape, alt) in \
                enumerate(cases):
            args = _decode_case(s, n_filled, pos, window, dtype, gen,
                                alternate=alt, **shape)
            want = decode_attention_ref(*args[:5], window=window)
            got = decode_attention(*args[:5], window=window)
            err = _check("decode_attention", label, got, want, dtype)
            if n_filled == 0 and window == 0 and \
                    not torch.equal(got, torch.zeros_like(got)):
                raise AssertionError(f"decode_attention {label}: not zero")
            timing = _time_decode(label, args)
            again = decode_attention(*args[:5], window=window)
            if not torch.equal(again, got):
                raise AssertionError(f"decode_attention {label}: result "
                                     "changed after graph replays")
            _counters_at_rest(f"decode_attention {label}")
            if i == 0 and dtype == torch.float32:
                row = dict(DECODE_ROW, max_abs_err=err, **timing)
    row = _decode_at_cases(gen, row)
    _flush.clear()
    one = torch.zeros(1, device="cuda")
    print(f"[kernels] practical floor: one launch of a one-element add_ "
          f"takes {device_ms(lambda: one.add_(1)):.5f} ms by graph replay")
    return row


# The serving cells' decode (portbench/traffic): qwen2-0.5b's heads over the
# 8193 slots of long_doc at its longest LP prompt (2048 tokens, 4 out) and a
# short one; phi3-mini's over 2044 slots with its window of 2047, before the
# cache is full and past it, where the cache rotates.  The position is a 0-d
# int32 tensor on the card, as the decode graph passes it.
DECODE_AT_CASES = (
    ("qwen2-0.5b long_doc S=8193 filled=2051", 8193, 2051, 2050, 0, {}),
    ("qwen2-0.5b long_doc S=8193 filled=516", 8193, 516, 515, 0, {}),
    ("phi3-mini long_doc S=2044 window=2047 pos=1027", 2044, 0, 1027, 2047,
     dict(h=32, kv=32, d=96)),
    ("phi3-mini long_doc S=2044 window=2047 rotated pos=2046", 2044, 0, 2046,
     2047, dict(h=32, kv=32, d=96)))


def _decode_at_cases(gen, row: dict) -> dict:
    """The decode kernel as the serving steps' graphs launch it: the
    position read on the card (:data:`DECODE_AT_CASES`).  Each case against
    the plain version at the kernel's tolerance and bit-equal to the launch
    at the same position as a host int; timed beside that launch.  ->
    ``row`` with the first f32 case as the kernel's main-path numbers."""
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        for label, s, n_filled, pos, window, shape in DECODE_AT_CASES:
            args = _decode_case(s, n_filled, pos, window, dtype, gen,
                                **shape)
            at = torch.tensor(pos, dtype=torch.int32, device="cuda")
            label = f"{label} position on the card"
            want = decode_attention_ref(*args[:5], window=window)
            got = decode_attention(*args[:4], at, window=window)
            err = _check("decode_attention", label, got, want, dtype)
            if not torch.equal(got, decode_attention(*args[:5],
                                                     window=window)):
                raise AssertionError(f"decode_attention {label}: differs "
                                     "from the launch at a host int")
            timing = _time_decode(label, args, at)
            again = decode_attention(*args[:4], at, window=window)
            if not torch.equal(again, got):
                raise AssertionError(f"decode_attention {label}: result "
                                     "changed after graph replays")
            _counters_at_rest(f"decode_attention {label}")
            if main is None:
                main = dict(case=label, max_abs_err=err, **timing)
    return dict(row, main_path=main)


def _time_decode(label: str, args, at=None) -> dict:
    """Device ms of the kernel (at the position tensor ``at`` where given,
    and then also at the host int), its plain version and SDPA, warm and
    with L2 flushed, and the bound."""
    q, k, v, positions, pos, window = args
    h, d = q.shape[1:]
    valid = (positions >= 0) & (positions <= pos)
    if window > 0:
        valid &= positions > pos - window
    n_valid = int(valid.sum())
    mask = valid[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return decode_attention(q, k, v, positions,
                                pos if at is None else at, window=window)

    def library():
        return sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    ms = device_ms(kernel)
    host = {} if at is None else {"host_int_ms": device_ms(
        lambda: decode_attention(q, k, v, positions, pos, window=window))}
    plain = device_ms(lambda: decode_attention_ref(q, k, v, positions, pos,
                                                   window=window))
    lib = device_ms(library)
    cold, lib_cold = cold_ms(kernel), cold_ms(library)
    # each input once (only the valid K/V rows are needed), output once
    kv_row = k.shape[2] * d * k.element_size()
    n_bytes = _nbytes(q, positions) + 2 * n_valid * kv_row + _nbytes(q)
    timing = _report("decode_attention", label, q.dtype, ms, plain, lib,
                     n_bytes, 4.0 * h * d * n_valid)
    print(f"[kernels] decode_attention {label} {str(q.dtype)[6:]}: "
          f"L2 flushed: kernel_cold_ms={cold:.5f} library_cold_ms="
          f"{lib_cold:.5f} (warm: {ms:.5f}, {lib:.5f})"
          + "".join(f"; the launch at a host int: {v:.5f} ms"
                    for v in host.values()))
    return dict(timing, cold_ms=cold, library_cold_ms=lib_cold, **host)


def _flash_cases(gen) -> dict:
    """The served prompt (T=16 at qwen2-0.5b's heads) and around it: short
    and ragged prompts, a window, no mask, a 1024-token prompt,
    deepseek-7b's attention (H = KV = 32, D = 128) at T=16 and T=1024,
    phi3-mini's (H = KV = 32, D = 96) at T=16, llava-next-34b's (H=56,
    KV=8, D=128) over its 2880-patch prefix and 16 tokens, seamless's
    (H = KV = 16, D = 64) unmasked at T=16 (its encoder, and its
    cross-attention in prefill) and T=1 (cross-attention of a decode token)
    over 16 frames, positions that do not start at 0, keys in a random
    order of positions (the tile skip on unsorted positions), the smoke
    configs' D=48 (zero-padded to 64), and the expanded MLA prefill of the
    DeepSeek models (H = KV = 128, D = nope 128 + rope 64 = 192 in the 256
    width class, V zero-padded from 128) at T=16 and T=1024.  Jamba's
    attention prefill (H=64, KV=8, D=128) takes llava's path.  Each case is
    checked, then timed warm and with L2 flushed."""
    qwen2 = dict(h=H, kv=KV, d=D)
    deepseek = dict(h=32, kv=32, d=128)
    seamless = dict(h=16, kv=16, d=64, s=PROMPT_LEN)
    mla = dict(h=128, kv=128, d=192, v_dim=128)
    cases = [(f"T={t} causal", t, True, 0, qwen2) for t in (8, 16, 37, 128)]
    cases += [("T=128 causal window=32", 128, True, 32, qwen2),
              ("T=37 non-causal", 37, False, 0, qwen2),
              ("T=1024 causal", 1024, True, 0, qwen2),
              ("deepseek-7b heads T=16 causal", 16, True, 0, deepseek),
              ("deepseek-7b heads T=1024 causal", 1024, True, 0, deepseek),
              ("phi3-mini heads (D=96) T=16 causal", 16, True, 0,
               dict(h=32, kv=32, d=96)),
              ("llava heads T=2896 causal", 2896, True, 0,
               dict(h=56, kv=8, d=128)),
              ("seamless heads T=16 S=16 non-causal", 16, False, 0,
               seamless),
              ("seamless heads T=1 S=16 non-causal (cross, decode)", 1,
               False, 0, seamless),
              ("T=16 causal positions 100..115", 16, True, 0,
               dict(qwen2, offset=100)),
              ("T=128 causal keys permuted", 128, True, 0,
               dict(qwen2, permuted=True)),
              ("D=48 H=4 KV=2 T=37 causal", 37, True, 0,
               dict(h=4, kv=2, d=48)),
              ("MLA heads (D=192, V padded from 128) T=16 causal", 16, True,
               0, mla),
              ("MLA heads (D=192, V padded from 128) T=1024 causal", 1024,
               True, 0, mla)]
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for label, t, causal, window, shape in cases:
            args = _flash_case(t, dtype, gen, **shape)
            want = flash_attention_ref(*args, causal=causal, window=window)
            got = flash_attention(*args, causal=causal, window=window)
            err = _check("flash_attention", label, got, want, dtype)
            timing = _time_flash(label, args, causal, window)
            if label == f"T={PROMPT_LEN} causal" and dtype == torch.float32:
                row = dict(FLASH_ROW, max_abs_err=err, **timing)
    return row


def _time_flash(label: str, args, causal: bool, window: int) -> dict:
    q, k, v, qp, kp = args
    b, t, h, d = q.shape
    mask = None
    n_pairs = b * qp.shape[0] * kp.shape[0]
    if causal:
        mask = kp[None, :] <= qp[:, None]
        if window > 0:
            mask &= kp[None, :] > qp[:, None] - window
        n_pairs = b * int(mask.sum())
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        return flash_attention(q, k, v, qp, kp, causal=causal, window=window)

    def library():
        return sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)

    calls = 50 if t * kp.shape[0] <= 1024 * 1024 else 5
    ms = device_ms(kernel, calls=calls)
    plain = device_ms(lambda: flash_attention_ref(q, k, v, qp, kp,
                                                  causal=causal,
                                                  window=window),
                      calls=calls)
    lib = device_ms(library, calls=calls)
    cold, lib_cold = cold_ms(kernel), cold_ms(library)
    n_bytes = _nbytes(q, k, v, qp, kp) + _nbytes(q)
    timing = _report("flash_attention", label, q.dtype, ms, plain, lib,
                     n_bytes, 4.0 * h * d * n_pairs)
    s, kv = k.shape[1], k.shape[2]
    plan = flash_ops.plan_flash(b, t, s, h, kv, d, q.dtype)
    qpl, kpl = qp.tolist(), kp.tolist()
    visited = sum(len(flash_ops.visit_list(plan, qpl, kpl, h // kv, by,
                                           causal, window))
                  for by in range(plan.n_row_tiles))
    print(f"[kernels] flash_attention {label} {str(q.dtype)[6:]}: L2 "
          f"flushed: kernel_cold_ms={cold:.5f} library_cold_ms="
          f"{lib_cold:.5f} (warm: {ms:.5f}, {lib:.5f}); plan {plan.rows} "
          f"rows a CTA in {plan.key_groups} key group(s), {plan.threads} "
          f"threads, grid {plan.grid}, {plan.tile_keys}-key tiles, "
          f"{plan.smem_bytes} B dynamic smem; K tiles visited {visited} of "
          f"{plan.n_row_tiles * plan.n_key_tiles} (per KV head and batch "
          "row)")
    return dict(timing, cold_ms=cold, library_cold_ms=lib_cold)


def _rel_check(name: str, label: str, names, got, want, dtype) -> float:
    """Each tensor against the plain version's, relative to the latter's
    largest magnitude: ``TOL`` of that."""
    torch.cuda.synchronize()
    worst, where = 0.0, ""
    for n, g, w in zip(names, got, want, strict=True):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {label}: non-finite {n}")
        rel = (g.float() - w.float()).abs().max().item() / \
            max(w.float().abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, n
    print(f"[kernels] {name} {label} {str(dtype)[6:]}: max error "
          f"{worst:.3g} of max |x| (at {where}; over {', '.join(names)}; "
          f"tol {TOL[dtype]:g})")
    if worst > TOL[dtype]:
        raise AssertionError(f"{name} {label}: {where} error {worst:.3g} of "
                             "its max")
    return worst


def _event_ms(fn, calls: int = 5) -> float:
    """Device time of one ``fn()`` between two CUDA events around
    ``calls`` back-to-back calls, after two warm-up calls (for an autograd
    backward, which a CUDA graph of this script's kind does not capture)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _flash_bwd_cases(gen) -> dict:
    """The backward kernel against its plain version on the card: qwen2's
    heads at T=16, 1024 and 4096 (the train step's shape), deepseek-7b's
    (H = KV = 32, D = 128) at T=1024, phi3-mini's D=96, MLA's (H = KV =
    128, D=192, V zero-padded from 128) at T=16 and 1024, a window,
    seamless's unmasked T=1 over 16 frames, positions 100..115 and one MLA
    head at T=14000 (the f32 statistics' 64-row instance); f32 and bf16.
    Each is timed (kernel and plain by CUDA-graph replay; the backward of
    ``scaled_dot_product_attention``, the yardstick, between events)
    beside its bound."""
    qwen2 = dict(h=H, kv=KV, d=D)
    mla = dict(h=128, kv=128, d=192, v_dim=128)
    cases = [(f"T={t} causal", t, True, 0, qwen2) for t in (16, 1024, 4096)]
    cases += [("deepseek-7b heads T=1024 causal", 1024, True, 0,
               dict(h=32, kv=32, d=128)),
              ("phi3-mini heads (D=96) T=16 causal", 16, True, 0,
               dict(h=32, kv=32, d=96)),
              ("MLA heads (D=192, V padded from 128) T=16 causal", 16, True,
               0, mla),
              ("MLA heads (D=192, V padded from 128) T=1024 causal", 1024,
               True, 0, mla),
              ("one MLA head (D=192) T=14000 causal (f32 statistics at 64 "
               "rows)", 14000, True, 0, dict(mla, h=1, kv=1)),
              ("T=128 causal window=32", 128, True, 32, qwen2),
              ("seamless heads T=1 S=16 non-causal (cross, decode)", 1,
               False, 0, dict(h=16, kv=16, d=64, s=PROMPT_LEN)),
              ("T=16 causal positions 100..115", 16, True, 0,
               dict(qwen2, offset=100))]
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for label, t, causal, window, shape in cases:
            q, k, v, qp, kp = args = _flash_case(t, dtype, gen, **shape)
            out = flash_attention(*args, causal=causal, window=window)
            d_out = torch.randn(q.shape, generator=gen,
                                device="cuda").to(dtype)
            bwd_args = (*args, out, d_out)
            want = flash_attention_bwd_ref(*bwd_args, causal=causal,
                                           window=window)
            got = flash_attention_bwd(*bwd_args, causal=causal,
                                      window=window)
            err = _rel_check("flash_attention_bwd", label, ("dq", "dk", "dv"),
                             got, want, dtype)
            del got, want
            timing = _time_flash_bwd(label, bwd_args, causal, window)
            if label == f"T={TRAIN_T} causal" and dtype == torch.float32:
                row = dict(FLASH_BWD_ROW, max_abs_err=err, **timing)
    return row


def _time_flash_bwd(label: str, bwd_args, causal: bool, window: int) -> dict:
    q, k, v, qp, kp, out, d_out = bwd_args
    b, t, h, d = q.shape
    mask = None
    n_pairs = b * qp.shape[0] * kp.shape[0]
    if causal:
        mask = kp[None, :] <= qp[:, None]
        if window > 0:
            mask &= kp[None, :] > qp[:, None] - window
        n_pairs = b * int(mask.sum())
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True)
    lib_grad = d_out.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qs, ks, vs), lib_grad,
                                   retain_graph=True)

    calls = 50 if t * kp.shape[0] <= 1024 * 1024 else 5
    ms = device_ms(lambda: flash_attention_bwd(*bwd_args, causal=causal,
                                               window=window), calls=calls)
    plain = device_ms(lambda: flash_attention_bwd_ref(
        *bwd_args, causal=causal, window=window), calls=calls)
    lib = _event_ms(library)
    del lib_out
    # the backward's five products (S again, dP, dV, dK, dQ) over the
    # valid pairs; q, k, v, out, d_out and positions read once, dq, dk, dv
    # written once
    n_bytes = _nbytes(q, k, v, qp, kp, out, d_out) + _nbytes(q, k, v)
    flops = 10.0 * h * d * n_pairs
    timing = _report("flash_attention_bwd", label, q.dtype, ms, plain, lib,
                     n_bytes, flops)
    # the kernel's own scheme on the tensor cores: in f32 six bf16 passes
    # a product, so the same work at a sixth of the bf16 peak
    tc_ms, tc_by = bound_ms(n_bytes, flops, TC_PEAK_FLOPS[q.dtype])
    plan = flash_ops.plan_flash_bwd(b, t, kp.shape[0], h, k.shape[2], d,
                                    q.dtype)
    print(f"[kernels] flash_attention_bwd {label} {str(q.dtype)[6:]}: "
          f"tensor-core bound_ms={tc_ms:.6f} ({tc_by}; "
          f"{TC_PEAK_FLOPS[q.dtype] / 1e12:.2f} TFLOP/s), share "
          f"{tc_ms / ms:.3f}; plan: stats {plan.stats_rows}-row CTAs x "
          f"{plan.stats_keys}-key tiles on grid {plan.stats_grid}; dK/dV "
          f"{plan.keys}-key CTAs ({plan.key_parts} warp(s) a 16 keys) over "
          f"{plan.step_rows}-row steps, rows in {plan.n_split} chunk(s) of "
          f"{plan.chunk}, grid {plan.key_grid}; dQ {plan.rows}-row CTAs "
          f"({plan.row_parts} warp(s) a 16 rows) x {plan.tile_keys}-key "
          f"tiles on grid {plan.row_grid}; dynamic smem {plan.smem_bytes} "
          "B; library_ms is SDPA's backward alone (autograd.grad between "
          "events)")
    if t == TRAIN_T:
        per = _launch_ms("flash_attention_bwd", BWD_SYMBOLS,
                         lambda: flash_attention_bwd(
                             *bwd_args, causal=causal, window=window))
        print(f"[kernels] flash_attention_bwd {label} {str(q.dtype)[6:]}: "
              "device ms a launch (torch.profiler, 3 calls): "
              + ", ".join(f"{k} {v:.5f}" for k, v in per.items()))
    return timing


def _launch_ms(name: str, symbols, fn, calls: int = 3) -> dict[str, float]:
    """Device ms a launch of each kernel whose symbol holds one of
    ``symbols`` (torch.profiler over ``calls`` calls of one launch each),
    over the launches the profiler recorded: it can drop one, and a mean
    over ``calls`` would then read low."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = {s: [0.0, 0] for s in symbols}
    for e in prof.key_averages():
        for s in symbols:
            if s in e.key:
                total[s][0] += e.self_device_time_total / 1e3
                total[s][1] += e.count
    if not all(n for _, n in total.values()):
        raise AssertionError(f"{name}: a launch missing from the profile: "
                             f"{total}")
    return {s: ms / n for s, (ms, n) in total.items()}


SLSTM_ROW = {"name": "slstm_scan", "route": "cuda",
             "source": "repro_torch/kernels/slstm_scan/csrc/slstm_scan.cu",
             "replaces": "src/repro/kernels/slstm_scan/kernel.py:71"}
HALO_ROW = {"name": "halo_conv2d", "route": "cuda",
            "source": "repro_torch/kernels/halo_conv2d/csrc/halo_conv2d.cu",
            "replaces": "src/repro/kernels/halo_conv2d/kernel.py:48",
            "standalone": True}


def _slstm_inputs(b: int, t: int, with_state: bool, dtype, gen,
                  heads: int = SH, dh: int = SDH) -> tuple:
    """wx [B,T,4,H,dh], R, bias (forget gate +3 as the model's init) and,
    with_state, a carry from 16 earlier steps of the plain version."""
    wx = 0.5 * torch.randn((b, t, 4, heads, dh), generator=gen, device="cuda")
    r = dh ** -0.5 * torch.randn((4, heads, dh, dh), generator=gen,
                                 device="cuda")
    bias = 0.1 * torch.randn((4, heads, dh), generator=gen, device="cuda")
    bias[1] += 3.0
    wx, r = wx.to(dtype), r.to(dtype)
    state = None
    if with_state:
        warm = (0.5 * torch.randn((b, 16, 4, heads, dh), generator=gen,
                                  device="cuda")).to(dtype)
        state = slstm_scan_ref(warm, r, bias)[1]
    return wx, r, bias, state


def _slstm_check(label: str, got, want, dtype) -> float:
    """hs and the four final-state tensors against the plain version."""
    err = _check("slstm_scan", label + " hs", got[0], want[0], dtype)
    for name, g, w in zip("hcnm", got[1], want[1]):
        err = max(err, _check("slstm_scan", f"{label} final {name}", g, w,
                              dtype))
    return err


def _slstm_plan(label: str, b: int, t: int, heads: int, dh: int,
                dtype) -> None:
    plan = slstm_ops.plan_scan(b, t, heads, dh, dtype)
    clusters = slstm_ops.max_active_clusters(plan, dtype,
                                             torch.device("cuda"))
    print(f"[kernels] slstm_scan {label} {str(dtype)[6:]} plan: {plan.n_cta} "
          f"CTAs a cluster x {plan.cols} columns, {plan.threads} threads, "
          f"grid {plan.grid}; R rows a k slice: {plan.register_rows} in "
          f"registers, {plan.rows_per_slice} in shared memory; of dh={dh}: "
          f"{plan.resident_rows} resident, {plan.streamed_rows} streamed; "
          f"{plan.smem_bytes} B dynamic shared memory a CTA; "
          f"cudaOccupancyMaxActiveClusters={clusters}")


def _slstm_cases(gen) -> dict:
    """Serving shapes of xlstm-1.3b's sLSTM (B=1, H=4, dh=512): a 16-token
    prompt from the zero state and one decode step from a carried state;
    then a ragged T, a longer batch, a ragged head dim (H=3, dh=100) and
    the largest (dh=1024).  Hidden states and the final state are held
    against the plain version; each case is timed warm and with L2 flushed.
    Then 200 decode steps in place (the cache update of every decode
    token), each held against the plain version's own trajectory, and two
    cluster sizes, which must agree bit for bit."""
    cases = [("B=1 T=16 zero state (prefill, main path)", 1, 16, False,
              SH, SDH),
             ("B=1 T=1 carried state (decode)", 1, 1, True, SH, SDH),
             ("B=1 T=37 carried state", 1, 37, True, SH, SDH),
             ("B=2 T=128 zero state", 2, 128, False, SH, SDH),
             ("B=1 T=16 H=3 dh=100 carried state", 1, 16, True, 3, 100),
             ("B=1 T=16 dh=1024 carried state", 1, 16, True, SH, 1024)]
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for i, (label, b, t, with_state, heads, dh) in enumerate(cases):
            _slstm_plan(label, b, t, heads, dh, dtype)
            wx, r, bias, state = _slstm_inputs(b, t, with_state, dtype, gen,
                                               heads, dh)
            want = slstm_scan_ref(wx, r, bias, state)
            err = _slstm_check(label, slstm_scan(wx, r, bias, state), want,
                               dtype)
            calls = 50 if t <= 16 else 5
            ms = device_ms(lambda: slstm_scan(wx, r, bias, state),
                           calls=calls)
            plain = device_ms(lambda: slstm_scan_ref(wx, r, bias, state),
                              calls=calls)
            cold = cold_ms(lambda: slstm_scan(wx, r, bias, state))
            st_bytes = _nbytes(*want[1]) * (2 if state is not None else 1)
            n_bytes = _nbytes(wx, r, bias, want[0]) + st_bytes
            # the product's multiply-adds, plus about 20 operations of
            # gating per state element and step
            flops = (2.0 * b * t * 4 * heads * dh * dh
                     + 20.0 * b * t * heads * dh)
            timing = _report("slstm_scan", label, dtype, ms, plain, None,
                             n_bytes, flops)
            print(f"[kernels] slstm_scan {label} {str(dtype)[6:]}: L2 "
                  f"flushed: kernel_cold_ms={cold:.5f} (warm: {ms:.5f})")
            if i == 0 and dtype == torch.float32:
                row = dict(SLSTM_ROW, max_abs_err=err, cold_ms=cold,
                           **timing)
        _slstm_decode_in_place(dtype, gen)
        _slstm_cluster_sizes(dtype, gen)
    return row


def _slstm_decode_in_place(dtype, gen, steps: int = 200) -> None:
    """``steps`` T=1 launches that update the state in place
    (``out_state=state``, as every decode token does), against the plain
    version stepping its own copy of the state."""
    wx, r, bias, state = _slstm_inputs(1, steps, True, dtype, gen)
    mine = tuple(s.clone() for s in state)
    ref = tuple(s.clone() for s in state)
    worst = 0.0
    for i in range(steps):
        x = wx[:, i:i + 1].contiguous()
        hs, out = slstm_scan(x, r, bias, mine, out_state=mine)
        if any(o is not s for o, s in zip(out, mine)):
            raise AssertionError("slstm_scan: out_state not returned")
        ref_hs, ref = slstm_scan_ref(x, r, bias, ref)
        torch.cuda.synchronize()
        for g, w in zip((hs, *mine), (ref_hs, *ref)):
            if not torch.isfinite(g).all():
                raise AssertionError(f"slstm_scan in-place step {i}: "
                                     "non-finite")
            worst = max(worst, (g - w).abs().max().item())
        if worst > TOL[dtype]:
            raise AssertionError(f"slstm_scan in-place step {i}: error "
                                 f"{worst} > {TOL[dtype]}")
    print(f"[kernels] slstm_scan {steps} decode steps in place "
          f"{str(dtype)[6:]}: max_abs_err={worst:.3g} over hs and the "
          f"state at every step (tol {TOL[dtype]:g})")


def _slstm_cluster_sizes(dtype, gen) -> None:
    """The serving shape with 16 and with 8 CTAs a cluster (another column
    split, and R's rows held elsewhere): hs and the final state must be
    bit-identical."""
    for label, t, with_state in (("T=16 zero state", 16, False),
                                 ("T=1 carried state", 1, True)):
        wx, r, bias, state = _slstm_inputs(1, t, with_state, dtype, gen)
        runs = [slstm_scan(wx, r, bias, state, n_cta=n) for n in (16, 8)]
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in
                   zip((runs[0][0], *runs[0][1]), (runs[1][0], *runs[1][1])))
        print(f"[kernels] slstm_scan {label} {str(dtype)[6:]}: 16 vs 8 CTAs "
              f"a cluster: {'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("slstm_scan: result depends on the cluster "
                                 "size")


# the sLSTM backward has no TPU counterpart: the JAX train step
# differentiates lax.scan over the model's _slstm_step
SLSTM_BWD_ROW = {"name": "slstm_scan_bwd", "route": "cuda",
                 "source": "repro_torch/kernels/slstm_scan/csrc/"
                           "slstm_scan_bwd.cu",
                 "replaces": None}
SLSTM_GRADS = ("dwx", "dR", "db", "dh0", "dc0", "dn0", "dm0")


def _flat(grads) -> list:
    """dwx, dR, db and the initial state's four gradients, in a list."""
    return [*grads[:3], *grads[3]]


def _flat_fwd(out) -> list:
    """hs, the final state and the saved pre, c, n, m, in a list."""
    return [out[0], *out[1], *out[2]]


def _slstm_bwd_cases(gen) -> dict:
    """The backward kernel at xlstm-1.3b's heads (H=4, dh=512): T=1, 16,
    1024 and TRAIN_T (the train step's) from the zero state, B=2 T=37
    from a given state with the final state's gradients, and a ragged
    dh=48; f32 and bf16.  First the forward's saving mode against the plain
    forward (hs, final state, pre, c, n, m); then the backward kernel and
    the plain backward on the plain forward's tensors, the four gradients
    and the initial state's relative to their largest magnitude; two runs,
    and 16 vs 8 CTAs a cluster, bit-identical.  Timed at T=1024 and
    TRAIN_T beside the plain version, the forward's saving mode and its
    bound; the backward launch alone by the profiler."""
    cases = [("T=1 zero state", 1, 1, False, SH, SDH),
             ("T=16 zero state", 1, 16, False, SH, SDH),
             ("T=1024 zero state", 1, 1024, False, SH, SDH),
             (f"T={TRAIN_T} zero state (train step)", 1, TRAIN_T, False, SH,
              SDH),
             ("B=2 T=37 given state, final-state gradients", 2, 37, True, SH,
              SDH),
             ("T=16 H=2 dh=48 given state, final-state gradients", 1, 16,
              True, 2, 48)]
    row = None
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, t, with_state, heads, dh in cases:
            wx, r, bias, state = _slstm_inputs(b, t, with_state, dtype, gen,
                                               heads, dh)
            dhs = torch.randn((b, t, heads, dh), generator=gen,
                              device="cuda")
            seeds = tuple(torch.randn((b, heads, dh), generator=gen,
                                      device="cuda")
                          for _ in range(4)) if with_state else None
            want_fwd = slstm_scan_saving_ref(wx, r, bias, state)
            got_fwd = slstm_scan_saving(wx, r, bias, state)
            _rel_check("slstm_scan", f"{label} saving mode",
                       ("hs", "h", "c", "n", "m", "pre", "c_all", "n_all",
                        "m_all"), _flat_fwd(got_fwd), _flat_fwd(want_fwd),
                       dtype)
            del got_fwd
            hs, _, saved = want_fwd
            args = (r, bias, state, hs, saved, dhs, seeds)
            got = _flat(slstm_scan_bwd(*args, wx_dtype=dtype))
            want = _flat(slstm_scan_bwd_ref(*args, wx_dtype=dtype))
            err = _rel_check("slstm_scan_bwd", label, SLSTM_GRADS, got, want,
                             dtype)
            del want
            again = [_flat(slstm_scan_bwd(*args, wx_dtype=dtype))]
            if dh == SDH:
                again.append(_flat(slstm_scan_bwd(*args, wx_dtype=dtype,
                                                  n_cta=8)))
            same = [all(torch.equal(x, y) for x, y in zip(got, run))
                    for run in again]
            print(f"[kernels] slstm_scan_bwd {label} {str(dtype)[6:]}: "
                  f"rerun bit-identical {same[0]}"
                  + (f"; 16 vs 8 CTAs a cluster bit-identical {same[1]}"
                     if len(same) > 1 else ""))
            if not all(same):
                raise AssertionError(f"slstm_scan_bwd {label}: results "
                                     "differ between runs or cluster sizes")
            del got, again
            if t >= 1024:
                timing = _time_slstm_bwd(label, wx, args)
                if t == TRAIN_T and dtype == torch.float32:
                    row = dict(SLSTM_BWD_ROW, max_abs_err=err, **timing)
    return row


def _time_slstm_bwd(label: str, wx, args) -> dict:
    r, bias, state, hs, saved, dhs, seeds = args
    b, t, heads, dh = hs.shape
    dtype = wx.dtype
    ms = device_ms(lambda: slstm_scan_bwd(*args, wx_dtype=dtype), calls=3,
                   reps=2)
    plain = _event_ms(lambda: slstm_scan_bwd_ref(*args, wx_dtype=dtype),
                      calls=1)
    fwd_save = device_ms(lambda: slstm_scan_saving(wx, r, bias, state),
                         calls=3, reps=2)
    fwd = device_ms(lambda: slstm_scan(wx, r, bias, state), calls=3, reps=2)
    launches = slstm_phases.bwd_launch_ms(r.transpose(2, 3).contiguous(),
                                          saved, dhs)
    launch = statistics.median(launches)
    parts = _slstm_bwd_parts(lambda: slstm_scan_bwd(*args, wx_dtype=dtype))
    got = slstm_scan_bwd(*args, wx_dtype=dtype)
    ins = (r, *saved, hs, dhs, *(state or ()), *(seeds or ()))
    # the recurrence's products and dR's, each 2 x 4 x dh^2 a (row, step,
    # head), plus about 40 operations of gating a state element and step
    product = 2.0 * 4 * dh * dh * b * t * heads
    flops = 2 * product + 40.0 * b * t * heads * dh
    timing = _report("slstm_scan_bwd", label, dtype, ms, plain, None,
                     _nbytes(*ins) + _nbytes(*_flat(got)), flops)
    # the kernel alone: R, pre, c, n, m, dhs in, dpre and the initial
    # state's gradient out, and the recurrence's products
    k_ms, k_by = bound_ms(_nbytes(r, *saved, dhs, *(state or ())[1:],
                                  *(seeds or ())) + _nbytes(*saved[:1])
                          + _nbytes(*got[3]), product, PEAK_FLOPS[dtype])
    tag = f"[kernels] slstm_scan_bwd {label} {str(dtype)[6:]}"
    print(f"{tag}: the backward launch alone, 5 launches (CUDA events "
          f"each): {slstm_phases.spread(launches)}, "
          f"{1e3 * launch / t:.4f} us a step at the median, against its "
          f"bound {k_ms:.6f} ms ({k_by}; the recurrence's "
          f"{product / 1e9:.3f} GFLOP), share {k_ms / launch:.3f}; the "
          f"rest of the call {ms - launch:.5f} ms; the forward in saving "
          f"mode {fwd_save:.5f} ms, in serving mode {fwd:.5f} ms")
    print(f"{tag}: the call by kernel (torch.profiler, 5 calls; ms a "
          "launch x launches recorded a call, which may miss one): "
          + "; ".join(f"{v:.5f} x{n:g} {k}" for k, (v, n) in parts.items()))
    if t == TRAIN_T:
        _dr_forms(tag, hs, got[0].float())
    return dict(timing, launch_ms=launch, forward_saving_ms=fwd_save)


def _dr_forms(tag: str, hs, dpre) -> None:
    """dR's product two ways: the einsum the wrapper calls (which copies
    dpre into the layout of one batched product over the heads), and one
    ``torch.bmm`` a gate on strided views that copies no operand."""
    b, t, four, heads, dh = dpre.shape

    def copy_free():
        h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
        a = h_prev.reshape(b * t, heads, dh).permute(1, 2, 0)
        d = dpre.reshape(b * t, four, heads, dh)
        dr = torch.empty((four, heads, dh, dh), device=dpre.device)
        for g in range(four):
            torch.bmm(a, d[:, g].transpose(0, 1), out=dr[g])
        return dr

    def einsum():
        return param_grads(None, hs, dpre, torch.float32, torch.float32)[0]

    diff = (copy_free() - einsum()).abs().max().item()
    print(f"{tag}: dR's product (CUDA events, 5 calls each): the einsum "
          f"with db {_event_ms(einsum):.5f} ms, a copy-free torch.bmm a "
          f"gate {_event_ms(copy_free):.5f} ms (max difference {diff:.3g})")


def _slstm_bwd_parts(fn, calls: int = 5) -> dict:
    """``calls`` calls of ``fn`` (the sLSTM backward's wrapper) under
    torch.profiler: the call's kernels by name -> (device ms a launch,
    launches recorded a call), largest first."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {e.key[:90]: (e.self_device_time_total / 1e3 / e.count,
                          e.count / calls)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0}
    if not any("slstm_bwd_kernel" in k for k in parts):
        raise AssertionError(f"slstm_scan_bwd: no backward launch in the "
                             f"profile of {calls} calls: {sorted(parts)}")
    return dict(sorted(parts.items(), key=lambda kv: -kv[1][0] * kv[1][1]))


def _halo_inputs(hw: int, chans: list[int], dtype, gen) -> tuple:
    """An image [1, hw, hw, chans[0]] and one [3, 3, C, C'] weight per pair
    of consecutive channel counts (He-scaled)."""
    x = torch.randn((1, hw, hw, chans[0]), generator=gen, device="cuda")
    ws = [(2.0 / (9 * ci)) ** 0.5 * torch.randn((3, 3, ci, co),
                                                 generator=gen,
                                                 device="cuda")
          for ci, co in zip(chans, chans[1:])]
    return x.to(dtype), [w.to(dtype) for w in ws]


def _halo_tiles_check(label: str, got, tl, ws, dtype) -> float:
    """The kernel against its plain version in f32 (before the final cast):
    equal up to f32 summation order and, in bf16, one rounding."""
    torch.cuda.synchronize()
    want = halo_conv_block_tiles_ref(tl.float(), [w.float() for w in ws])
    err = (got.float() - want).abs()
    limit = HALO_F32_TOL * max(1.0, want.abs().max().item()) + \
        HALO_ROUND[dtype] * want.abs()
    same = torch.equal(got, want.to(dtype))
    print(f"[kernels] halo_conv2d {label} tiles vs plain {str(dtype)[6:]}: "
          f"max_abs_err={err.max().item():.3g} against the f32 plain result "
          f"(tol {HALO_F32_TOL:g} x max(1, max|y|) + {HALO_ROUND[dtype]:g} "
          f"x |y|); {'bit-identical' if same else 'not bit-identical'} to "
          f"the plain version")
    if not torch.isfinite(got).all() or (err > limit).any():
        raise AssertionError(f"halo_conv2d {label}: kernel differs from its "
                             "plain version beyond f32 summation order")
    return (got.float() - want.to(dtype).float()).abs().max().item()


def _halo_check(label: str, got, want, dtype) -> float:
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"halo_conv2d {label}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = HALO_TOL[dtype] * scale
    print(f"[kernels] halo_conv2d {label} {str(dtype)[6:]}: "
          f"max_abs_err={err:.3g} (tol {tol:.3g} = {HALO_TOL[dtype]:g} x "
          f"max(1, max|y|))")
    if err > tol:
        raise AssertionError(f"halo_conv2d {label}: error {err} > {tol}")
    return err


def _halo_cases(gen) -> dict:
    """YoloV2 (darknet yolov2.cfg at a 416x416 input) conv blocks: the
    104x104x128 and 52x52x256 layers with 2 fused 3x3 convs split over the
    paper's 2 and 4 cores, and the 26x26x512 layer alone on 4; then a small
    ragged block (3 -> 13 -> 13 channels: zero-filled loads, a masked N
    edge).  Each tiled run is held against the tiles' plain version and the
    whole-image cuDNN block, and the two tilings against each other
    (exactly)."""
    cases = [(104, [128] * 3), (52, [256] * 3), (26, [512] * 2),
             (20, [3, 13, 13])]
    row = None
    halo_conv_block_tiles.launches = 0
    halo_conv_block_tiles.split_launches = 0
    timings = []
    for dtype in (torch.float32, torch.bfloat16):
        for hw, chans in cases:
            n = len(chans) - 1
            x, ws = _halo_inputs(hw, chans, dtype, gen)
            whole = conv_block_ref(x, ws)
            width = (str(chans[0]) if len(set(chans)) == 1
                     else "->".join(map(str, chans)))
            outs = {}
            for tiles in ([(1, 2), (2, 2)] if n > 1 else [(2, 2)]):
                label = f"{hw}x{hw}x{width} n={n} tiles={tiles}"
                th, tw = hw // tiles[0], hw // tiles[1]
                tl = _extract_tiles(F.pad(x, (0, 0, n, n, n, n)), *tiles, th,
                                    tw, n)
                got = halo_conv_block_tiles(tl, ws, tile_h=th, tile_w=tw)
                err = _halo_tiles_check(label, got, tl, ws, dtype)
                outs[tiles] = halo_conv_block(x, ws, tiles=tiles)
                _halo_check(label + " block vs cuDNN block", outs[tiles],
                            whole, dtype)
                timings.append((label, dtype, tl, ws, th, tw, x, err))
            if len(outs) == 2:
                diff = (outs[(1, 2)].float() - outs[(2, 2)].float()).abs()
                print(f"[kernels] halo_conv2d {hw}x{hw}x{width} n={n} tiles "
                      f"(1, 2) vs (2, 2) {str(dtype)[6:]}: max_abs_diff="
                      f"{diff.max().item():.3g} (exact)")
                if not torch.equal(outs[(1, 2)], outs[(2, 2)]):
                    raise AssertionError("halo_conv2d: result depends on "
                                         "the tiling")
    launches = halo_conv_block_tiles.launches
    print(f"[kernels] halo_conv2d: {launches} conv kernel launches and "
          f"{halo_conv_block_tiles.split_launches} split kernel launches in "
          "the checked calls of this phase (standalone: no model runs it)")
    lib = _build.load("halo_conv2d")
    for label, dtype, tl, ws, th, tw, x, err in timings:
        ms = device_ms(lambda: halo_conv_block_tiles(tl, ws, tile_h=th,
                                                     tile_w=tw), calls=10)
        plain = device_ms(lambda: halo_conv_block_tiles_ref(tl, ws),
                          calls=10)
        lib_ms = device_ms(lambda: conv_block_ref(x, ws), calls=10)
        out_shape = (tl.shape[0], th, tw, ws[-1].shape[-1])
        chans = [ws[0].shape[2]] + [w.shape[3] for w in ws]
        plans = plan_block(tl.shape[0], tl.shape[1], tl.shape[2], chans,
                           dtype)
        flops = issued = 0.0
        hin, win = tl.shape[1], tl.shape[2]
        for w, plan in zip(ws, plans):
            hin, win = hin - 2, win - 2
            layer = 2.0 * 9 * w.shape[2] * w.shape[3] * tl.shape[0] * hin * win
            flops += layer
            issued += len(plan.k_walk[2]) * layer
        n_bytes = _nbytes(tl, *ws) + tl.element_size() * \
            out_shape[0] * out_shape[1] * out_shape[2] * out_shape[3]
        # the bound counts the bf16 tensor-core products the split passes
        # issue; the useful flops are the convolution's own
        timing = _report("halo_conv2d", label, dtype, ms, plain, lib_ms,
                         n_bytes, issued, peak=PEAK_FLOPS[torch.bfloat16])
        smem = [lib.halo_conv3x3_smem_bytes(p.a_planes, p.b_planes, p.tile)
                for p in plans]
        print(f"[kernels] halo_conv2d {label} {str(dtype)[6:]}: passes per "
              f"layer {[len(p.k_walk[2]) for p in plans]} at the bf16 "
              f"tensor-core peak {PEAK_FLOPS[torch.bfloat16] / 1e12:g} "
              "TFLOP/s; "
              f"achieved {flops / ms / 1e9:.1f} TFLOP/s of the convolution "
              f"({issued / ms / 1e9:.1f} issued); CTA tiles "
              f"{[p.tile for p in plans]}, grids {[p.grid for p in plans]}, "
              f"dynamic smem {smem} B")
        if label.startswith("104x104x128 n=2 tiles=(2, 2)") and \
                dtype == torch.float32:
            row = dict(HALO_ROW, max_abs_err=err, launches=launches,
                       **timing)
    return row




# --------------------------------------------------------------------------- #
# Phase 3: serve full-width qwen2-0.5b, phi3-mini-3.8b and xlstm-1.3b         #
# --------------------------------------------------------------------------- #


KERNELS = {"decode_attention": decode_attention,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd,
           "slstm_scan": slstm_scan, "slstm_scan_bwd": slstm_scan_bwd,
           "halo_conv2d": halo_conv_block_tiles}


def _n_layers(stages, mixer: str) -> int:
    return sum(st.repeats for st in stages for ld in st.pattern
               if ld.mixer == mixer)


def _expected_launches(cfg, prefills: int, tokens: int) -> dict[str, int]:
    """One launch per layer per prefill (flash for decoder and encoder
    self-attention, for MLA's expanded prefill and for cross-attention,
    sLSTM scan over the prompt) and per decode token (decode attention for
    attention layers, none for MLA's absorbed decode, flash for
    cross-attention, one sLSTM step).  Mamba, MoE and the FFNs launch none
    of the port's kernels."""
    attn, slstm = _n_layers(cfg.stages, "attn"), _n_layers(cfg.stages,
                                                          "slstm")
    mla = _n_layers(cfg.stages, "mla")
    enc = _n_layers(cfg.encoder_stages, "attn")
    cross = sum(st.repeats for st in cfg.stages for ld in st.pattern
                if ld.cross_attn)
    return {"decode_attention": attn * tokens,
            "flash_attention": (attn + mla + enc + cross) * prefills
            + cross * tokens, "flash_attention_bwd": 0,
            "slstm_scan": slstm * (prefills + tokens), "slstm_scan_bwd": 0,
            "halo_conv2d": 0}


def _counted(fn, counter: list):
    """``fn`` with its calls counted in ``counter[0]`` and, of them, the
    steps replayed from a CUDA graph (``tracing.replays`` moved) in
    ``counter[1]``."""
    def wrapped(*a, **kw):
        before = tracing.replays
        out = fn(*a, **kw)
        counter[0] += 1
        counter[1] += tracing.replays != before
        return out
    return wrapped


def _check_eager_launches(label: str, cfg, launches: dict, prefills: int,
                          tokens: int, replays: tuple) -> None:
    """The kernel wrappers count the launches made from the host: one
    step's for each prefill and decode step not replayed from a CUDA graph
    (a replay launches its kernels on the card, a capture runs none)."""
    want = _expected_launches(cfg, prefills - replays[0],
                              tokens - replays[1])
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, "
                             f"expected {want} ({prefills} prefills and "
                             f"{tokens} decode steps, {replays} of them "
                             "replayed)")


def _reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _engine_run(cfg, params, cost, setup=None) -> tuple:
    """The request mix (``N_REQUESTS``, 2:1 HP:LP, prompts from seed 1)
    through ``PreemptiveServingEngine`` with 4 slices x 4 units on
    ``params``, its slots from ``cost`` -> (requests, metrics, each
    kernel's launches, prefills, decode tokens, wall s).  ``setup``, where
    given, is called with the engine once the requests are queued (the
    churn phase's probes and events).  The launches are those the kernel
    wrappers counted from the host (:func:`_check_eager_launches`); the
    last item holds the prefills and decode steps replayed from a CUDA
    graph."""
    net = engine_network_config(cost, LP_TOKENS)
    eng = PreemptiveServingEngine(cfg, params, cost, device="cuda",
                                  n_slices=4, units_per_slice=4,
                                  preemption=True, lose_work=True, net=net)
    prefills, tokens = [0, 0], [0, 0]
    eng._prefill = _counted(eng._prefill, prefills)
    eng._serve = _counted(eng._serve, tokens)

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
    if setup is not None:
        setup(eng)

    _reset_launches()
    t0 = time.perf_counter()
    m = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return reqs, m, _launches(), prefills[0], tokens[0], wall, \
        (prefills[1], tokens[1])


def phase_serve(arch: str, keep, cpu_cut) -> dict[str, int]:
    """Serve the request mix on ``arch`` at full width (its decoder cut to
    ``keep`` where given, see :func:`_cut`); returns each kernel's launches
    in the engine run.  The cost model's own weights are freed before the
    served ones are made."""
    cfg = _cut(get_config(arch), keep)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cost = measure_cost_model(cfg, prompt_len=PROMPT_LEN,
                              cache_len=CACHE_LEN, reps=3, device="cuda")
    print(f"[serve] {arch} cost model in {time.perf_counter() - t0:.2f} s: "
          f"prefill {cost.prefill[1]}, decode {cost.decode}")
    gc.collect()                        # the cost model's own weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    print(f"[serve] {arch}: {cfg.n_layers} layers"
          f"{_cut_note(arch, cfg, keep)} d={cfg.d_model} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.padded_vocab}, {n_params} params "
          f"({_nbytes(*_leaves(params)) / 1e9:.2f} GB, {cfg.param_dtype}) "
          f"initialised in {time.perf_counter() - t0:.2f} s")
    _check_params(arch, n_params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                                     generator=gen, device="cuda")}
    per_step = _step_device_times("[serve]", cfg, params, cost, batch,
                                  CACHE_LEN, PROMPT_LEN)
    _counters_at_rest(f"{arch} step replays")
    reqs, m, launches, prefills, tokens, wall, replays = _engine_run(
        cfg, params, cost)
    replayed = _replayed_launches(arch, per_step, replays)
    hp_reqs = [r for r in reqs if r.priority == Priority.HIGH]
    lp_done = [r for r in reqs
               if r.priority == Priority.LOW and r.state == "done"]
    print(f"[serve] {arch} engine run {wall:.2f} s wall: HP "
          f"{sum(r.state == 'done' for r in hp_reqs)}/{len(hp_reqs)} done, "
          f"LP {len(lp_done)}/{len(reqs) - len(hp_reqs)} done, "
          f"{m.preemptions} preemptions, {m.realloc_success} victim "
          f"reallocations, {m.lp_offloaded} LP offloaded")
    print(f"[serve] {arch} summary " + json.dumps(m.summary(), default=str))
    print(f"[serve] {arch} kernel launches in the engine run "
          f"({prefills} prefills, {tokens} decode tokens; {replays[0]} and "
          f"{replays[1]} of them replayed from CUDA graphs): from the host "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + "; in the replays (replays x the kernels the profiler counted "
          "in one) " + ", ".join(f"{k}={v}" for k, v in replayed.items()))
    _peak_memory("[serve]", arch, "cost model, init, steps and engine run")
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
    _check_eager_launches(f"[serve] {arch}", cfg, launches, prefills,
                          tokens, replays)
    if not any(launches.values()) and not any(replayed.values()):
        raise AssertionError(f"[serve] {arch}: no port kernel ran")

    if arch == "xlstm-1.3b":
        _check_xlstm_logits(cfg, params, reqs[0].prompt)
    else:
        _check_against_cpu(*_sub(cfg, params, cpu_cut),
                           {"tokens": reqs[0].prompt})
    return launches, replayed


def _replayed_launches(arch: str, per_step: dict, replays: tuple) -> dict:
    """The attention kernels that an engine run's replayed steps ran: the
    replays of each step times the kernels the profiler counted in one
    replay of it (:func:`_step_device_times`)."""
    out = {}
    for step, n in zip(("prefill", "decode"), replays):
        if n and step not in per_step:
            raise AssertionError(f"{arch}: {n} {step} steps replayed, but "
                                 "the profiled one was not")
        for k, v in per_step.get(step, {}).items():
            out[k] = out.get(k, 0) + n * v
    return out


def _step_device_times(tag: str, cfg, params, cost, batch: dict,
                       cache_len: int, pos: int, calls: int = 3) -> dict:
    """Device time of one prefill of ``batch`` and one decode step at
    ``pos`` from CUDA-graph replay (no host gaps), beside the host-fenced
    times the cost model measured (degree 2 is the measured decode time):
    the gap is host dispatch, during which the device idles.  Then one of
    each step under the profiler, for the breakdown by kernel.  -> for
    each step that the profiled call replayed from the serving steps' own
    graph, the attention kernels it ran, checked against one step's
    launches."""
    pre = make_prefill_step(cfg, cache_len, device="cuda")
    srv = make_serve_step(cfg, device="cuda")
    nxt, caches = pre(params, batch)
    last = nxt[:, None]
    t = M.prefix_len(cfg) + batch["tokens"].shape[1]
    steps = (("prefill", cost.prefill[1].mean_s,
              device_ms(lambda: pre(params, batch), calls=calls, reps=3)),
             ("decode", cost.decode[2].mean_s,
              device_ms(lambda: srv(params, caches, last, pos), calls=calls,
                        reps=3)))
    weights_ms = 1e3 * _nbytes(*_leaves(params)) / HBM_BYTES_PER_S
    for name, host_s, dev_ms in steps:
        at = f"T={t}" if name == "prefill" else f"pos={pos}"
        print(f"{tag} {cfg.name} {name} step {at}: host-fenced (cost model) "
              f"{1e3 * host_s:.3f} ms, device {dev_ms:.3f} ms "
              f"(graph replay), device idle share "
              f"{1 - dev_ms / (1e3 * host_s):.3f}; weights read once "
              f"{weights_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12} TB/s")
    # the tree the first prefill handed out was copied out by the timed
    # prefills' replays: a prefill hands out the resident tree again, and a
    # decode on it is captured (where the graphs engage) before its profile
    nxt, caches = pre(params, batch)
    last = nxt[:, None]
    srv(params, caches, last, pos)
    per_step = {}
    for name, fn, at, n in (    # decode first: a prefill copies out caches
            ("decode", lambda: srv(params, caches, last, pos), f"pos={pos}",
             (0, 1)),
            ("prefill", lambda: pre(params, batch), f"T={t}", (1, 0))):
        before = tracing.replays
        ran = _profile(f"{cfg.name} {name} {at}", fn)
        if tracing.replays == before:
            continue
        want = {k: v for k, v in _expected_launches(cfg, *n).items()
                if k in ATTENTION_KERNELS and v}
        print(f"{tag} {cfg.name} {name} step {at} replayed from its CUDA "
              f"graph: the profiler counts {ran} port kernels, one step "
              f"launches {want}")
        if ran != want:
            raise AssertionError(f"{cfg.name} {name} replay ran {ran}, "
                                 f"expected {want}")
        per_step[name] = ran
    return per_step


# substrings of the port's kernel symbols, as the profiler names them
PORT_KERNEL_SYMBOLS = ("decode_attention", "flash_attention", "slstm",
                       "halo_conv")


# the serving steps' port kernels, by their kernels' symbols
ATTENTION_KERNELS = ("decode_attention", "flash_attention")


def _profile(label: str, fn, top: int = 10) -> dict[str, int]:
    """One warm ``fn()`` under ``torch.profiler``: its host-fenced wall
    time, the summed device time of its kernels, and the kernels that take
    the most of it, grouped by name.  The profiler slows the host, so the
    busy share here is below the one graph replay gives.  -> how often
    each of :data:`ATTENTION_KERNELS` ran, by the profiler's count of its
    kernel's name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    print(f"[profile] {label}: wall {wall_ms:.3f} ms (host-fenced, under "
          f"the profiler), device busy {busy_ms:.3f} ms in "
          f"{sum(e.count for e in kernels)} kernel launches, busy share "
          f"{busy_ms / wall_ms:.3f}")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"[profile] {label}:   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% "
              f"x{e.count:<5d} {e.key[:100]}")
    # the port's own kernels, wherever they rank
    counts: dict[str, int] = {}
    for rank, e in enumerate(ranked, 1):
        if any(name in e.key for name in PORT_KERNEL_SYMBOLS):
            ms = e.self_device_time_total / 1e3
            print(f"[profile] {label}: port kernel #{rank}: {ms:.3f} ms "
                  f"{100 * ms / busy_ms:.1f}% x{e.count} {e.key[:100]}")
            for name in ATTENTION_KERNELS:
                if f"{name}_kernel" in e.key:
                    counts[name] = counts.get(name, 0) + e.count
    return counts


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _tree_to(tree, device):
    return _tree_map(tree, lambda v: v.to(device))


def _stages(cfg, keep) -> tuple:
    return tuple(StageDef(tuple(cfg.stages[i].pattern[j] for j in slots),
                          reps) for i, slots, reps in keep)


def _cut(cfg, keep=None, n_modality: int | None = None):
    """``cfg`` with its decoder cut to ``keep`` ((stage, pattern slots,
    repeats) kept, in order; None: all) and, for a decoder-only modality
    model, ``n_modality`` prefix positions.  Each kept layer keeps its kind
    and full width."""
    if keep is not None:
        stages = _stages(cfg, keep)
        cfg = replace(cfg, stages=stages, n_layers=sum(
            len(st.pattern) * st.repeats for st in stages))
    if n_modality is not None:
        cfg = replace(cfg, n_modality_tokens=n_modality)
    return cfg


def _sub(cfg, params, keep):
    """``cfg`` and ``params`` cut to ``keep`` (as :func:`_cut`; None: the
    whole model), the kept layers' weights as views of ``params``."""
    if keep is None:
        return cfg, params
    small = {k: v for k, v in params.items() if not k.startswith("dec")}
    for n, (i, slots, reps) in enumerate(keep):
        small[f"dec{n}"] = {
            f"p{m}": _tree_map(params[f"dec{i}"][f"p{j}"],
                               lambda v, reps=reps: v[:reps])
            for m, j in enumerate(slots)}
    return _cut(cfg, keep), small


def _kinds(cfg) -> str:
    """The decoder's layer kinds, stage by stage."""
    return ", ".join(
        f"{st.repeats} x " + " + ".join(f"{ld.mixer}/{ld.ffn}"
                                        for ld in st.pattern)
        for st in cfg.stages)


def _cut_note(arch: str, cfg, keep) -> str:
    if keep is None:
        return ""
    return f" (cut from {get_config(arch).n_layers}: {_kinds(cfg)})"


def _check_params(arch: str, n_params: int) -> None:
    if arch in JAX_PARAMS and n_params != JAX_PARAMS[arch]:
        raise AssertionError(f"{arch} holds {n_params} params, the JAX tree "
                             f"{JAX_PARAMS[arch]}")


def _peak_memory(tag: str, arch: str, over: str) -> None:
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} {arch} peak device memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB; max_memory_allocated over {over})")
    if peak >= CARD_BYTES:
        raise AssertionError(f"{arch}: peak device memory {peak} B")


def _print_gaps(tag: str, label: str, **runs: list) -> None:
    """The smallest router gap of each run (MoE models only)."""
    if all(runs.values()):
        mins = ", ".join(f"{name} {min(g):.3g}" for name, g in runs.items())
        print(f"{tag} {label}: smallest router gap between a token's k-th "
              f"and (k+1)-th score: {mins} over "
              f"{len(next(iter(runs.values())))} routings")


@contextmanager
def _router_gaps(gaps: list):
    """Records, for each MoE routing, the smallest gap between a token's
    k-th and (k+1)-th router score: a top-k flip between two runs shows
    where that gap is near their difference."""
    top_k = FF._top_k

    def spy(scores, k):
        vals = torch.sort(scores.float(), dim=-1, descending=True).values
        gaps.append(float((vals[..., k - 1] - vals[..., k]).min()))
        return top_k(scores, k)

    FF._top_k = spy
    try:
        yield
    finally:
        FF._top_k = top_k


def _logits(cfg, params, batch: dict, dev, cache_len: int = CACHE_LEN,
            decode: torch.Tensor | None = None,
            pos_on_card: bool = False) -> list:
    """Prefill of ``batch``, then one decode step per token of ``decode``
    (teacher forced; default: the prompt's last token) from the same
    weights: the logits of each, on the CPU.  With ``pos_on_card`` each
    decode step takes its position as a 0-d int32 tensor on ``dev``, as
    the serving steps' decode graph does."""
    prompt = batch["tokens"]
    if decode is None:
        decode = prompt[:, -1:]
    pre, caches = M.prefill(params, cfg, {k: v.to(dev)
                                          for k, v in batch.items()},
                            cache_len)
    out = [pre.float().cpu()]
    pos = M.prefix_len(cfg) + prompt.shape[1]
    for i in range(decode.shape[1]):
        at = torch.tensor(pos + i, dtype=torch.int32, device=dev) \
            if pos_on_card else pos + i
        dec, _ = M.decode_step(params, cfg, caches,
                               decode[:, i:i + 1].to(dev), at)
        out.append(dec.float().cpu())
    return out


def _compare_logits(tag: str, label: str, got: list, want: list) -> None:
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        phase = "prefill" if i == 0 else f"decode {i}"
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label} {phase} logits not finite")
        err = (g - w).abs().max().item()
        print(f"{tag} {label} {phase} logits [1, 1, {g.shape[-1]}]: "
              f"max_abs_err={err:.3g} (tol {LOGIT_TOL:g}, logits "
              f"max |x|={w.abs().max().item():.3g})")
        if err > LOGIT_TOL:
            raise AssertionError(f"{label} {phase} logits differ by {err}")


@torch.inference_mode()
def _check_against_cpu(cfg, params, batch: dict, tag: str = "[serve]",
                       cache_len: int = CACHE_LEN,
                       decode: torch.Tensor | None = None) -> None:
    """The card (kernels) against the CPU (plain versions); for an MoE
    model with the smallest router top-k gap of each run.  Where the
    serving steps' graphs take ``cfg`` the card decodes at positions held
    on the card, as their decode graph does."""
    card, cpu = [], []
    on_card = graphs.supported(cfg)
    with _router_gaps(card):
        got = _logits(cfg, params, batch, "cuda", cache_len, decode,
                      pos_on_card=on_card)
    with _router_gaps(cpu):
        want = _logits(cfg, _tree_to(params, "cpu"), batch, "cpu",
                       cache_len, decode)
    label = (f"{cfg.name} card vs CPU ({cfg.n_layers} layer(s)"
             + (", decode position on the card)" if on_card else ")"))
    _print_gaps(tag, label, card=card, CPU=cpu)
    _compare_logits(tag, label, got, want)


@torch.inference_mode()
def _check_xlstm_logits(cfg, params, prompt) -> None:
    """All 48 layers with the sLSTM kernel against the same model on the
    card with the sLSTM plain version in its place; then one full-width
    superblock (7 mLSTM + 1 sLSTM) with the kernel against the CPU (a CPU
    copy of the whole 14 GB model is not needed for that)."""
    batch = {"tokens": prompt}
    got = _logits(cfg, params, batch, "cuda")
    X.slstm_scan = slstm_scan_ref
    try:
        want = _logits(cfg, params, batch, "cuda")
    finally:
        X.slstm_scan = slstm_scan
    _compare_logits("[serve]", f"{cfg.name} sLSTM kernel vs plain on the "
                    "card", got, want)
    pattern = cfg.stages[0].pattern
    one = replace(cfg, n_layers=len(pattern), stages=(StageDef(pattern, 1),))
    small = M.init_params(one, 0, device="cuda")
    _compare_logits("[serve]", f"{cfg.name} one superblock card vs CPU",
                    _logits(one, small, batch, "cuda"),
                    _logits(one, _tree_to(small, "cpu"), batch, "cpu"))


# --------------------------------------------------------------------------- #
# Phase 3b: slice churn through the engine                                    #
# --------------------------------------------------------------------------- #


CHURN_ARCH = "qwen2-0.5b"
CHURN_SLICES = 4                      # _engine_run's engine: 4 slices x 4
CHURN_ROOM = 1.25                     # room sought for a re-placed orphan,
#                                       in LP slots of the fewest units


def churn_probe(eng, slots: list) -> None:
    """Record each slot of ``eng`` into ``slots`` as it begins: priority,
    slice, home slice and window.  At an LP slot's midpoint an event reads the calendars (it
    decides nothing): whether the slot is still reserved (``alive``) and
    which other slices could take one more LP slot of the fewest units from
    then on (``room``)."""
    run_compute = eng._run_compute
    units = eng.net.lp_core_options[0]
    span = CHURN_ROOM * eng.net.lp_slot_time(units)
    devices = eng.state.devices

    def record(task) -> None:
        slot = {"hp": task.priority == Priority.HIGH, "slice": task.device,
                "home": task.source_device, "t_start": task.t_start,
                "t_end": task.t_end}
        slots.append(slot)
        if not slot["hp"]:
            dev, mid = task.device, 0.5 * (task.t_start + task.t_end)

            def look() -> None:
                slot["alive"] = devices[dev].get(task) is not None
                slot["room"] = [d.device for d in devices
                                if d.is_up and d.device != dev
                                and d.fits(mid, mid + span, units)]
            eng.q.push(mid, look)
        run_compute(task)
    eng._run_compute = record


def _mid(slot: dict) -> float:
    return 0.5 * (slot["t_start"] + slot["t_end"])


def _room_lp(slots: list) -> list:
    """The LP slots of ``slots`` still reserved at their midpoint that found
    room on another slice there (an orphan of theirs can be re-placed)."""
    return [s for s in slots if not s["hp"] and s.get("alive")
            and s.get("room")]


def place_hp_failure(slots: list) -> list:
    """The first failure of the churn schedule, placed on the slots of a
    run without churn (:func:`churn_probe`): the slice of the first HP slot
    fails at its midpoint, while the HP request is reserved there, and
    rejoins one HP slot later -> ``[(virtual s, kind, slice)]``."""
    hp = [s for s in slots if s["hp"]]
    if not hp:
        raise AssertionError("no HP slot")
    slot = min(hp, key=_mid)
    t = _mid(slot)
    return [(t, "fail", slot["slice"]),
            (t + slot["t_end"] - slot["t_start"], "rejoin", slot["slice"])]


def place_churn(slots: list, hp_failure: list, n_slices: int) -> list:
    """The churn schedule -> ``[(virtual s, kind, slice)]``, from
    ``hp_failure`` (:func:`place_hp_failure`) and the slots of a run with
    it alone: after it, the slice running the first LP slot (a local one
    first: its home slice) on another slice that is still reserved at its
    midpoint and finds room on another slice there (its orphans can be
    re-placed) fails at that midpoint; a third slice drains just after;
    the LP slot's slice rejoins an HP slot later."""
    (t2, _, s2), (back2, _, _) = hp_failure
    lp = [s for s in _room_lp(slots) if s["slice"] != s2 and _mid(s) > t2]
    if not lp:
        raise AssertionError(f"no LP slot off slice {s2} finds room on "
                             f"another slice after {t2}")
    first = min(lp, key=lambda s: (s["slice"] != s["home"], _mid(s)))
    s1, t1 = first["slice"], _mid(first)
    s3 = next(i for i in range(n_slices) if i not in (s1, s2))
    return sorted(hp_failure + [(t1, "fail", s1), (t1 + 1e-3, "drain", s3),
                                (t1 + back2 - t2, "rejoin", s1)])


def placed_churn(run, n_slices: int) -> tuple:
    """The churn schedule placed on two runs of the same mix: ``run(setup)``
    serves it with ``setup`` called on the engine and returns its result.
    The first run has no churn (:func:`place_hp_failure` reads its slots),
    the second the HP failure alone (:func:`place_churn` reads its slots)
    -> (schedule, the first run's result, the second's)."""
    slots, slots2 = [], []
    base = run(lambda eng: churn_probe(eng, slots))
    hp_failure = place_hp_failure(slots)
    hooks = churn_events(hp_failure, [])

    def setup(eng) -> None:
        churn_probe(eng, slots2)
        hooks(eng)
    second = run(setup)
    return place_churn(slots2, hp_failure, n_slices), base, second


def churn_events(events: list, lost: list):
    """A ``setup`` for :func:`_engine_run` (any engine with the same
    slice-churn calls) that queues ``events``; each failure appends to
    ``lost`` its time, slice, orphans as ``(request, state before the
    failure)`` and the requests re-placed at once."""
    def setup(eng) -> None:
        def fire(kind: str, idx: int) -> None:
            if kind != "fail":
                (eng.drain_slice if kind == "drain" else
                 eng.rejoin_slice)(idx)
                return
            state = {r.rid: r.state for r in eng._by_task.values()}
            dec = eng.fail_slice(idx)
            orphans = [eng._by_task[t] for t in dec.preempted]
            lost.append({"t": eng.q.now, "slice": idx,
                         "orphans": [(r, state[r.rid]) for r in orphans],
                         "replaced": [eng._by_task[a.task]
                                      for a in dec.reallocations]})
        for t, kind, idx in events:
            eng.q.push(t, lambda kind=kind, idx=idx: fire(kind, idx))
    return setup


def phase_churn() -> None:
    """Full-width qwen2-0.5b serving the request mix as in ``[serve]``,
    without churn, then with slices failing, draining and rejoining at
    times placed on the timelines of that run and of one with the first
    failure alone (:func:`placed_churn`).  A request that
    lost its slice restarts its prefill (the flash kernel) and decode (the
    decode kernel) elsewhere.  Checks every request settled, HP requests
    done or counted as failed admissions, orphans created and recovered,
    recovered requests' tokens equal to the first run's (greedy decoding
    of the same prompt and weights), exact launches with the restarts,
    the decode kernel's counters at rest, and the engine's device memory
    freed once it is dropped (orphaned caches do not leak)."""
    cfg = get_config(CHURN_ARCH)
    cost = measure_cost_model(cfg, prompt_len=PROMPT_LEN,
                              cache_len=CACHE_LEN, reps=3, device="cuda")
    gc.collect()
    params = M.init_params(cfg, 0, device="cuda")
    print(f"[churn] {cfg.name} cost model: prefill {cost.prefill[1]}, "
          f"decode {cost.decode}")
    events, (base, m0, _, pre0, tok0, wall0, _), second = placed_churn(
        lambda setup: _engine_run(cfg, params, cost, setup=setup),
        CHURN_SLICES)
    print(f"[churn] {cfg.name} run without churn {wall0:.2f} s wall: "
          f"{sum(r.state == 'done' for r in base)}/{len(base)} done, "
          f"{pre0} prefills, {tok0} decode tokens, {m0.preemptions} "
          f"preemptions; with the HP failure alone {second[5]:.2f} s wall")
    print("[churn] schedule (virtual s, kind, slice): " + ", ".join(
        f"{t:.6f} {kind} {idx}" for t, kind, idx in events))
    lost, engines = [], []
    hooks = churn_events(events, lost)

    def setup(eng) -> None:
        engines.append(weakref.ref(eng))
        hooks(eng)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    reqs, m, launches, pre, tok, wall, replays = _engine_run(
        cfg, params, cost, setup=setup)
    gc.collect()                        # the engine's own reference cycles
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    summary = m.summary()
    print(f"[churn] {cfg.name} churn run {wall:.2f} s wall: "
          f"{sum(r.state == 'done' for r in reqs)}/{len(reqs)} done, "
          f"{pre} prefills, {tok} decode tokens; summary "
          + json.dumps(summary, default=str))
    index = {r.rid: i for i, r in enumerate(reqs)}
    for f in lost:
        print(f"[churn] slice {f['slice']} failed at {f['t']:.6f}: orphans "
              + ", ".join(f"#{index[r.rid]} {r.priority.name} (was "
                          f"{was})" for r, was in f["orphans"])
              + "; re-placed at once: "
              + (", ".join(f"#{index[r.rid]}" for r in f["replaced"])
                 or "none"))
    if [f["slice"] for f in lost] != [e[2] for e in events
                                      if e[1] == "fail"]:
        raise AssertionError(f"failures {lost}, scheduled {events}")
    if not any(r.priority == Priority.HIGH for r, _ in lost[0]["orphans"]):
        raise AssertionError("the first failure orphaned no HP request")
    if not any(r.priority == Priority.LOW and was == "running"
               for r, was in lost[1]["orphans"]):
        raise AssertionError("the second failure orphaned no running LP "
                             "decode")
    unresolved = [(index[r.rid], r.state) for r in reqs
                  if r.state not in ("done", "failed")]
    hp = [r for r in reqs if r.priority == Priority.HIGH]
    hp_failed = sum(r.state == "failed" for r in hp)
    print(f"[churn] unresolved {len(unresolved)}; HP "
          f"{len(hp) - hp_failed}/{len(hp)} done, {hp_failed} failed "
          f"(hp_failed_alloc {m.hp_failed_alloc}); orphans created "
          f"{m.orphans_created}, recovered {m.orphans_recovered}")
    if unresolved:
        raise AssertionError(f"requests not settled: {unresolved}")
    if hp_failed != m.hp_failed_alloc or m.hp_failed_runtime or \
            len(hp) - hp_failed != m.hp_completed:
        raise AssertionError(f"HP outcomes {[r.state for r in hp]} vs "
                             f"{summary}")
    if m.orphans_created < 2 or m.orphans_recovered < 1:
        raise AssertionError(f"orphans created {m.orphans_created}, "
                             f"recovered {m.orphans_recovered}")
    recovered = {r.rid: r for f in lost for r in f["replaced"]
                 if r.state == "done"}
    if not recovered:
        raise AssertionError("no re-placed orphan finished")
    for rid, r in recovered.items():
        want = base[index[rid]]
        if want.state != "done" or r.tokens_out != want.tokens_out:
            raise AssertionError(
                f"recovered request #{index[rid]}: tokens {r.tokens_out}, "
                f"without churn {want.state} {want.tokens_out}")
    print(f"[churn] recovered requests "
          + ", ".join(f"#{index[rid]}" for rid in recovered)
          + f": {sum(len(r.tokens_out) for r in recovered.values())} "
          "tokens, bit-equal to the run without churn")
    print(f"[churn] kernel launches from the host in the churn run "
          f"({pre} prefills, {tok} decode tokens, restarts included, "
          f"{replays[0]} and {replays[1]} of them replayed from CUDA graphs; "
          f"{pre0} and {tok0} without churn): " + ", ".join(
              f"{k}={v}" for k, v in launches.items() if v))
    _check_eager_launches("[churn]", cfg, launches, pre, tok, replays)
    if not _expected_launches(cfg, pre, tok)["flash_attention"]:
        raise AssertionError("[churn]: no prefill ran")
    _counters_at_rest("the churn run")
    print("[churn] decode_attention counters at rest after the churn run")
    print(f"[churn] device memory allocated {before} B before the churn "
          f"run, {after} B once its engine is dropped")
    if engines[0]() is not None:
        raise AssertionError("the churn run's engine is still referenced")
    if after != before:
        raise AssertionError(f"device memory {after - before:+d} B after "
                             "the churn run")


# --------------------------------------------------------------------------- #
# Phase 3c: the host runtimes                                                 #
# --------------------------------------------------------------------------- #


SIM_SCENARIOS = ("UPS", "UNPS", "WPS_4", "WNPS_4", "DPW", "DNPW", "CPW",
                 "CNPW")
# (HP %, frames %, preemptions, victim reallocations) of each paper
# scenario at its 1296 frames, as the JAX package's run_scenario gives them
# (tests/test_torch_sim.py holds this table against it)
PAPER_1296 = {
    "UPS": (99.29, 52.1, 491, 0),
    "UNPS": (83.36, 48.28, 0, 0),
    "WPS_4": (99.29, 26.95, 224, 0),
    "WNPS_4": (82.81, 26.85, 0, 0),
    "DPW": (100.0, 14.8, 4618, 0),
    "DNPW": (80.7, 22.7, 0, 0),
    "CPW": (100.0, 13.06, 4608, 0),
    "CNPW": (81.23, 18.87, 0, 0),
}
SIM_CHAOS = ("smoke", "churn_mixed")
STREAM_REQUESTS = 20_000
STREAM_DEVICES = 64
STREAM_RSS_GROWTH = 32 * 2**20        # benchmarks/soak.py's absolute gate
#                                       (not its 10 %: this process holds
#                                       torch and the card's context)


def stream_network() -> NetworkConfig:
    """Serve-style slots (sub-second tasks, a 5 GB/s shared link), as
    benchmarks/soak.py times its soak."""
    prof = TaskProfile(name="serve", hp_exec=0.020, hp_pad=0.002,
                       lp_exec={2: 0.200, 4: 0.120},
                       lp_pad={2: 0.010, 4: 0.008}, input_bytes=21500,
                       output_bytes=550, hp_deadline_slack=0.50,
                       lp_deadline=5.0)
    spec = WorkloadSpec(name="soak_serve", profiles={"serve": prof},
                        default_type="serve")
    return NetworkConfig(throughput_bps=5e9, jitter_pad_s=2e-5,
                         workload=spec)


def _rss() -> int:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _stream_soak() -> None:
    """``STREAM_REQUESTS`` firehose arrivals through ``StreamingEngine`` on
    ``STREAM_DEVICES`` devices (soak's smoke shape: 4.8 arrivals a device
    a second, 50 ms windows); every admitted task settles and the
    process's RSS stays flat (first quarter of the samples dropped, the
    early and late halves' means compared)."""
    reset_id_counters()
    eng = StreamingEngine(STREAM_DEVICES, net=stream_network(),
                          queue_capacity=8192, shed="reject_cheapest",
                          window=0.05)
    fire = FirehoseConfig(name="soak", n_devices=STREAM_DEVICES,
                          rate=4.8 * STREAM_DEVICES, lp_fraction=0.4,
                          lp_set_sizes=(1, 2, 3, 4), seed=0)
    rss = [_rss()]

    def on_window(e) -> None:
        if e.telemetry.windows % 4 == 0:
            rss.append(_rss())
    t0 = time.perf_counter()
    report = eng.run(firehose(fire, limit=STREAM_REQUESTS),
                     on_window=on_window)
    wall = time.perf_counter() - t0
    rss.append(_rss())
    tail = rss[len(rss) // 4:]
    half = max(1, len(tail) // 2)
    early, late = sum(tail[:half]) / half, sum(tail[-half:]) / half
    allowed = STREAM_RSS_GROWTH
    m, tel = report["metrics"], report["telemetry"]
    print(f"[sim] stream {STREAM_REQUESTS} requests on {STREAM_DEVICES} "
          f"devices in {wall:.2f} s ({STREAM_REQUESTS / wall:.0f} "
          f"requests/s host): HP {m['hp_completion_pct']} %, LP "
          f"{m['lp_completion_pct']} %, shed {tel['shed_total']}, "
          f"unresolved {report['unresolved']}; RSS {early / 2**20:.1f} -> "
          f"{late / 2**20:.1f} MB over {len(rss)} samples (allowed growth "
          f"{allowed / 2**20:.1f} MB)")
    if report["unresolved"] or report["in_flight"] or report["queued"]:
        raise AssertionError(f"stream run left work unsettled: {report}")
    if late - early > allowed:
        raise AssertionError(f"RSS grew {(late - early) / 2**20:.1f} MB")


def phase_sim() -> None:
    """The port's host runtimes on the card machine's Python: the paper's
    testbed scenarios at 1296 frames against the JAX package's numbers,
    the chaos scenarios and the degrade storm with their gates, and a
    streaming soak.  Each raises on its first failure."""
    for name in SIM_SCENARIOS:
        cfg = SCENARIOS[name]
        t0 = time.perf_counter()
        s = run_scenario(cfg).summary()
        got = (s["hp_completion_pct"], s["frame_completion_pct"],
               s["preemptions"], s["realloc_success"])
        print(f"[sim] {name} ({cfg.algorithm}, "
              f"{'preemption' if cfg.preemption else 'no preemption'}, "
              f"{cfg.trace}) {cfg.n_frames} frames a device x "
              f"{cfg.n_devices}: HP {got[0]} %, "
              f"frames {got[1]} %, {got[2]} preemptions, {got[3]} "
              f"reallocations ({s['realloc_failure']} failed) in "
              f"{time.perf_counter() - t0:.2f} s")
        if s["frames_total"] != cfg.n_frames * cfg.n_devices or \
                got != PAPER_1296[name]:
            raise AssertionError(f"{name}: {got}, the JAX package gives "
                                 f"{PAPER_1296[name]}")
    for name in SIM_CHAOS:
        cfg = CHAOS_SCENARIOS[name]
        t0 = time.perf_counter()
        res = run_chaos(cfg)
        failures = chaos_gate(res, cfg)
        print(f"[sim] chaos {name}: {cfg.n_devices} devices, failed "
              f"{res['devices_failed']}, drained {res['devices_drained']}, "
              f"rejoined {res['devices_rejoined']}, orphans "
              f"{res['orphans_created']}, recovered "
              f"{res['orphans_recovered']}, HP {res['hp_completion_pct']} "
              f"%, unresolved {res['unresolved']} in "
              f"{time.perf_counter() - t0:.2f} s; gate "
              f"{'passed' if not failures else failures}")
        if failures:
            raise AssertionError(f"chaos {name}: {failures}")
    cfg = storm.STORM_SCENARIOS["smoke"]
    t0 = time.perf_counter()
    res = storm.run_storm(cfg)
    failures = storm.storm_gate(res, cfg)
    print(f"[sim] degrade storm smoke: accuracy-weighted goodput "
          f"{res['reject_only']['awg_pct']} % rejecting, "
          f"{res['degrade']['awg_pct']} % degrading (gain "
          f"{res['awg_gain_pct']}), HP delta {res['hp_delta_pct']}, "
          f"{res['degrade']['lp_degraded']} degraded in "
          f"{time.perf_counter() - t0:.2f} s; gate "
          f"{'passed' if not failures else failures}")
    if failures:
        raise AssertionError(f"degrade storm: {failures}")
    _stream_soak()


# --------------------------------------------------------------------------- #
# Phase 4: run deepseek-7b, seamless-m4t-medium and llava-next-34b            #
# --------------------------------------------------------------------------- #


# arch, cut of the decoder (None: all), and the cut of the card-vs-CPU
# comparison with the modality positions it keeps (None: the whole model)
MODELS = (("deepseek-7b", None, None),
          ("seamless-m4t-medium", None, None),
          ("llava-next-34b", ((0, (0,), 12),), (FIRST_LAYER, 64)),
          ("deepseek-v3-671b", V3_CUT, (FIRST_LAYER, None)),
          ("jamba-1.5-large-398b", JAMBA_CUT, (FIRST_LAYER, None)))
MODEL_TOKENS = 8                      # decode tokens held against references


@contextmanager
def _plain_attention():
    """The attention layers with both kernels' plain versions in their
    place (on the card, no launch counted)."""
    A.flash_attention, A.decode_attention = (flash_attention_ref,
                                             decode_attention_ref)
    L.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        A.flash_attention, A.decode_attention = (flash_attention,
                                                 decode_attention)
        L.flash_attention = flash_attention


def _model_batch(cfg, gen) -> dict:
    """A PROMPT_LEN-token prompt and the modality embeddings the model
    takes: llava's n_modality_tokens patches, seamless's PROMPT_LEN frames
    (as the cost model makes them)."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                                     generator=gen, device="cuda")}
    if cfg.modality_embed_dim:
        n = cfg.n_modality_tokens or PROMPT_LEN
        batch["modality_emb"] = torch.randn((1, n, cfg.modality_embed_dim),
                                            generator=gen, device="cuda")
    return batch


def phase_model(arch: str, keep, cpu_cut) -> None:
    """A model the engine does not serve (it passes tokens only, as the
    JAX engine does), at full width (its decoder cut to ``keep`` where
    given) with random weights from seed 0: the cost model, step device
    times and ``[profile]`` lines at the model's real positions, then one
    prefill and MODEL_TOKENS decode tokens with exact launch counts, their
    logits held against the plain versions on the card and against the CPU
    (at ``cpu_cut`` = (layers kept, modality positions) where given).  The
    cost model's own weights are freed before the model's are made."""
    cfg = _cut(get_config(arch), keep)
    prefix = M.prefix_len(cfg)
    cache_len = prefix + CACHE_LEN
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cost = measure_cost_model(cfg, prompt_len=PROMPT_LEN,
                              cache_len=cache_len, reps=3, device="cuda")
    print(f"[model] {arch} cost model in {time.perf_counter() - t0:.2f} s: "
          f"prefill {cost.prefill[1]}, decode {cost.decode} (its decode "
          f"runs at pos={PROMPT_LEN}, as the JAX cost model's)")
    gc.collect()                        # the cost model's own weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device="cuda")
    leaves = list(_leaves(params))
    torch.cuda.synchronize()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batch = _model_batch(cfg, gen)
    decode = torch.randint(0, cfg.vocab_size, (1, MODEL_TOKENS),
                           generator=gen, device="cuda")
    emb = batch.get("modality_emb")
    n_params = sum(t.numel() for t in leaves)
    print(f"[model] {arch}: {cfg.n_layers} decoder layers"
          f"{_cut_note(arch, cfg, keep)}, {cfg.n_encoder_layers} encoder "
          "layers, "
          f"d={cfg.d_model} H={cfg.n_heads} KV={cfg.n_kv_heads} "
          f"D={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.padded_vocab}, modality_emb "
          f"{'-' if emb is None else list(emb.shape)}, {n_params} params, "
          f"{_nbytes(*leaves) / 1e9:.2f} GB ({cfg.param_dtype}) initialised "
          f"in {time.perf_counter() - t0:.2f} s; cache {cache_len} slots")
    _check_params(arch, n_params)
    del leaves
    _step_device_times("[model]", cfg, params, cost, batch, cache_len,
                       prefix + PROMPT_LEN, calls=1 if prefix else 3)
    _counters_at_rest(f"{arch} step replays")

    with torch.inference_mode():
        _reset_launches()
        gaps: list = []
        with _router_gaps(gaps):
            got = _logits(cfg, params, batch, "cuda", cache_len, decode)
        torch.cuda.synchronize()
        launches = _launches()
        want = _expected_launches(cfg, 1, MODEL_TOKENS)
        print(f"[model] {arch} kernel launches in one prefill and "
              f"{MODEL_TOKENS} decode tokens: "
              + ", ".join(f"{k}={v}" for k, v in launches.items()))
        if launches != want:
            raise AssertionError(f"{arch}: kernel launches {launches}, "
                                 f"expected {want}")
        plain_gaps: list = []
        with _plain_attention(), _router_gaps(plain_gaps):
            plain = _logits(cfg, params, batch, "cuda", cache_len, decode)
        _print_gaps("[model]", f"{arch} kernels vs plain on the card",
                    kernels=gaps, plain=plain_gaps)
        _compare_logits("[model]", f"{arch} kernels vs plain on the card",
                        got, plain)
    _peak_memory("[model]", arch, "cost model, init, steps and logits")
    if cpu_cut is None:
        _check_against_cpu(cfg, params, batch, "[model]", cache_len, decode)
        return
    layers, n_mod = cpu_cut
    small_cfg, small = _sub(_cut(cfg, n_modality=n_mod), params, layers)
    small_batch = dict(batch)
    if n_mod is not None:
        small_batch["modality_emb"] = batch["modality_emb"][:, :n_mod]
    print(f"[model] {arch} card vs CPU at a cut: {small_cfg.n_layers} "
          f"decoder layer(s) of full width ({_kinds(small_cfg)}), "
          f"{M.prefix_len(small_cfg)} modality positions + {PROMPT_LEN} "
          "tokens")
    _check_against_cpu(small_cfg, small, small_batch, "[model]",
                       M.prefix_len(small_cfg) + CACHE_LEN, decode)


# --------------------------------------------------------------------------- #
# Phase 5: train qwen2-0.5b at full width                                     #
# --------------------------------------------------------------------------- #


TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SHAPE = SHAPES["train_4k"]      # T=4096, global batch 256
TRAIN_T = TRAIN_SHAPE.seq_len
TRAIN_BATCH = 1                       # cut from 256: one sequence a step
TRAIN_STEPS = 3
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=8)
TRAIN_CPU_CUT = ((0, (0,), 2),)       # card vs CPU: 2 full-width layers
TRAIN_CPU_T = 256                     # (the CPU's 151,936-word head)
# A gradient leaf against another run of the same step, relative to the
# leaf's largest |g|: f32 summation order through 24 layers (kernel vs
# plain, cuBLAS vs the CPU's BLAS); a dropped attention gradient is off by
# about 1.
TRAIN_GRAD_TOL = 1e-3
CKPT_DIR = Path(__file__).resolve().parent / "build" / "train_ckpt"


def _grads(cfg, params: dict, batch: dict) -> tuple:
    """(loss, gradient leaves) as the train step takes them (recompute
    on), without the optimizer."""
    loss, _, grads = loss_and_grads(params, cfg, batch)
    return loss, list(tree_leaves(grads))


def _leaf_names(tree, prefix: str = ""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_names(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k


def _compare_grads(label: str, names, got, want) -> float:
    """Every gradient leaf within TRAIN_GRAD_TOL of the other run, relative
    to that leaf's largest |g|; returns the worst ratio."""
    worst, where = 0.0, ""
    for name, g, w in zip(names, got, want, strict=True):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: non-finite gradient {name}")
        scale = w.float().abs().max().item()
        ratio = (g.float() - w.to(g.device).float()).abs().max().item() / \
            max(scale, 1e-30)
        if ratio > worst:
            worst, where = ratio, name
        if ratio > TRAIN_GRAD_TOL:
            raise AssertionError(f"{label}: gradient {name} off by {ratio:.3g}"
                                 f" of its max |g| {scale:.3g}")
    print(f"[train] {label}: {len(names)} gradient leaves, worst "
          f"max|diff| / max|g| = {worst:.3g} at {where} (tol "
          f"{TRAIN_GRAD_TOL:g})")
    return worst


@contextmanager
def _plain_flash_autograd():
    """``flash_attention``'s autograd path with the plain forward and
    backward in place of the kernels (no launch counted)."""
    fwd, bwd = flash_ops._forward, flash_ops.flash_attention_bwd
    flash_ops._forward = lambda q, k, v, qp, kp, causal, window: \
        flash_attention_ref(q, k, v, qp, kp, causal=causal, window=window)
    flash_ops.flash_attention_bwd = flash_attention_bwd_ref
    try:
        yield
    finally:
        flash_ops._forward, flash_ops.flash_attention_bwd = fwd, bwd


def _expected_train_launches(cfg, steps: int) -> dict[str, int]:
    """A train step under recompute runs each attention layer's flash
    forward and each sLSTM layer's scan (in its saving mode) twice
    (forward, then again in the backward) and their backward kernels once;
    no other kernel."""
    attn = _n_layers(cfg.stages, "attn")
    slstm = _n_layers(cfg.stages, "slstm")
    return {"decode_attention": 0, "flash_attention": 2 * attn * steps,
            "flash_attention_bwd": attn * steps,
            "slstm_scan": 2 * slstm * steps,
            "slstm_scan_bwd": slstm * steps, "halo_conv2d": 0}


def _check_metrics(tag: str, metrics: dict) -> None:
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(torch.isfinite(torch.tensor(list(vals.values())))):
        raise AssertionError(f"{tag}: non-finite metrics {vals}")
    if not vals["grad_norm"] > 0:
        raise AssertionError(f"{tag}: grad_norm {vals['grad_norm']}")


class _OptimizerTimer:
    """Wraps the train step's ``adamw_update`` with CUDA events, so one
    step's optimizer device time can be read after it."""

    def __init__(self):
        self.update, self.events = TS.adamw_update, []

    def __enter__(self):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.update(*a, **kw)
            end.record()
            self.events.append((start, end))
            return out
        TS.adamw_update = timed
        return self

    def __exit__(self, *exc):
        TS.adamw_update = self.update

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


BWD_SYMBOLS = ("bwd_stats_kernel", "bwd_dkdv_kernel", "bwd_dq_kernel")
# the port's kernels in a train step, by symbol: (kind, the group whose
# share of the step is printed)
TRAIN_KERNELS = {**{s: (s, "flash backward (the three launches)")
                    for s in BWD_SYMBOLS},
                 "flash_attention_kernel": ("flash forward", None),
                 "slstm_cluster_kernel": ("sLSTM forward (saving mode)",
                                          "sLSTM forward (saving mode)"),
                 "slstm_bwd_kernel": ("sLSTM backward", "sLSTM backward")}


def _profile_train_step(label: str, fn) -> None:
    """One train step under ``torch.profiler``: device time by kind (the
    port's kernels: flash forward, each launch of its backward, the sLSTM
    forward and backward; cuBLAS products, the optimizer's kernels by CUDA
    events, everything else elementwise)."""
    torch.cuda.synchronize()
    with _OptimizerTimer() as opt_timer, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        raise AssertionError(f"{label}: the profiler recorded no device time")
    kinds: dict[str, list] = {}
    for e in kernels:
        key = next((kind for s, (kind, _) in TRAIN_KERNELS.items()
                    if s in e.key), None)
        if key is None:
            key = ("cuBLAS products" if any(
                       s in e.key.lower() for s in ("gemm", "gemv", "cublas",
                                                    "cutlass"))
                   else "elementwise, reductions, optimizer")
        ms_n = kinds.setdefault(key, [0.0, 0])
        ms_n[0] += e.self_device_time_total / 1e3
        ms_n[1] += e.count
    print(f"[profile] {label}: wall {wall_ms:.3f} ms (host-fenced, under "
          f"the profiler), device busy {busy:.3f} ms in "
          f"{sum(e.count for e in kernels)} kernel launches, busy share "
          f"{busy / wall_ms:.3f}")
    for key, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label}:   {ms:10.3f} ms {100 * ms / busy:5.1f}% "
              f"x{n:<6d} {key}")
    groups: dict[str, float] = {}
    for kind, group in TRAIN_KERNELS.values():
        if group is not None and kind in kinds:
            groups[group] = groups.get(group, 0.0) + kinds[kind][0]
    for group, ms in groups.items():
        print(f"[profile] {label}:   {group}: {ms:.3f} ms a step, "
              f"{100 * ms / busy:.1f}% of device busy")
    launches = [e.self_device_time_total / 1e3 for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "slstm_bwd_kernel" in e.name]
    if launches:
        print(f"[profile] {label}:   sLSTM backward, each of its "
              f"{len(launches)} launches: "
              f"{slstm_phases.spread(launches)}; "
              + ", ".join(f"{x:.5f}" for x in launches))
    print(f"[profile] {label}:   of which the optimizer (adamw_update, "
          f"between CUDA events): {opt_timer.ms():.3f} ms")


def _train_batches(cfg, t: int, n: int) -> list:
    shape = InputShape(f"{TRAIN_SHAPE.name} cut", t, TRAIN_BATCH, "train")
    stream = train_batches(cfg, shape, batch_override=TRAIN_BATCH)
    return [next(stream) for _ in range(n)]


def _check_card_vs_cpu(cfg, keep=TRAIN_CPU_CUT) -> None:
    """``keep``'s layers at full width, T=TRAIN_CPU_T: the card's loss,
    gradients and updated params against the CPU's from the same state."""
    cut = _cut(cfg, keep)
    params, opt_state = init_train_state(cut, 1, TRAIN_OPT, device="cuda")
    cpu_params = _tree_map(params, lambda v: v.detach().to("cpu", copy=True))
    cpu_state = _tree_map(opt_state, lambda v: v.to("cpu", copy=True))
    batch, = _train_batches(cut, TRAIN_CPU_T, 1)
    names = list(_leaf_names(params))
    loss, got = _grads(cut, params, batch)
    want_loss, want = _grads(cut, cpu_params, batch)
    print(f"[train] card vs CPU at {cut.n_layers} full-width layers, "
          f"T={TRAIN_CPU_T}: loss {loss.item():.7f} vs "
          f"{want_loss.item():.7f}")
    if abs(loss.item() - want_loss.item()) > 1e-4:
        raise AssertionError(f"card vs CPU loss {loss.item()} vs "
                             f"{want_loss.item()}")
    _compare_grads("card vs CPU", names, got, want)
    del got
    # one step on each: elements whose gradient is near 0 on one side may
    # move by lr the other way (Adam's first step is lr x sign(g))
    params, _, m = make_train_step(cut, TRAIN_OPT, device="cuda")(
        params, opt_state, batch)
    cpu_params, _, cm = make_train_step(cut, TRAIN_OPT, device="cpu")(
        cpu_params, cpu_state, batch)
    lr = float(cm["lr"])
    worst, flipped, total = 0.0, 0, 0
    for name, p, c, g in zip(names, tree_leaves(params),
                             tree_leaves(cpu_params), want, strict=True):
        diff = (p.detach().cpu() - c.detach()).abs()
        tiny = g.abs() <= TRAIN_GRAD_TOL * g.abs().max()
        worst = max(worst, diff[~tiny].max().item() if (~tiny).any() else 0)
        flipped += int((diff > 1e-5).sum())
        total += diff.numel()
        if diff.max().item() > 2 * lr + 1e-5:
            raise AssertionError(f"card vs CPU update: {name} moved apart "
                                 f"by {diff.max().item()}")
    print(f"[train] card vs CPU after one step (lr {lr:.3g}): params "
          f"within {worst:.3g} where |g| > {TRAIN_GRAD_TOL:g} max|g|; "
          f"{flipped} of {total} elements apart by more than 1e-5 (all "
          f"within 2 lr); grad_norm {float(m['grad_norm']):.7f} vs "
          f"{float(cm['grad_norm']):.7f}")
    if worst > 1e-5:
        raise AssertionError(f"card vs CPU update differs by {worst}")


def _init_train(arch: str, cfg) -> tuple:
    """Full-width params and AdamW state of ``cfg`` from seed 0 on the
    card -> (params, opt_state, leaf names)."""
    t0 = time.perf_counter()
    params, opt_state = init_train_state(cfg, 0, TRAIN_OPT, device="cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    print(f"[train] {arch}: {cfg.n_layers} layers ({_kinds(cfg)}), "
          f"d={cfg.d_model} H={cfg.n_heads} KV={cfg.n_kv_heads} "
          f"D={cfg.resolved_head_dim}, {n_params} params ({cfg.param_dtype}, "
          f"AdamW moments in {TRAIN_OPT.moment_dtype}) initialised in "
          f"{time.perf_counter() - t0:.2f} s; {TRAIN_SHAPE.name} shape "
          f"T={TRAIN_T} at batch {TRAIN_BATCH} (cut from "
          f"{TRAIN_SHAPE.global_batch}); {TRAIN_OPT}")
    _check_params(arch, n_params)
    return params, opt_state, list(_leaf_names(params))


def _timed_step(cfg, step, params, opt_state, batch, i: int,
                total: dict) -> tuple:
    """Train step ``i``, host-fenced: finite metrics, its launches exact
    (added to ``total``) -> (params, opt_state)."""
    before = _launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt_state, metrics = step(params, opt_state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = {k: v - before[k] for k, v in _launches().items()}
    for k, v in launches.items():
        total[k] += v
    _check_metrics(f"step {i}", metrics)
    print(f"[train] {cfg.name} step {i}: loss {float(metrics['loss']):.6f} "
          f"grad_norm {float(metrics['grad_norm']):.6f} lr "
          f"{float(metrics['lr']):.6g}; {1e3 * dt:.3f} ms host-fenced, "
          f"{TRAIN_BATCH * TRAIN_T / dt:.1f} tokens/s; launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items()))
    if launches != _expected_train_launches(cfg, 1):
        raise AssertionError(f"step {i} launches {launches}")
    return params, opt_state


def phase_train() -> dict[str, int]:
    """Full-width qwen2-0.5b trains TRAIN_STEPS steps at T=4096 (batch 1),
    recompute on: exact launches, finite loss and gradients, peak memory;
    its gradients after step 1 against the plain flash forward/backward on
    the card; a checkpoint after step 2 restored and step 3 run from the
    live and the restored state, bit for bit; 8 greedy tokens decoded from
    the restored weights; then 2 layers at T=256 against the CPU.  Returns
    the launches of the TRAIN_STEPS steps."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, names = _init_train(TRAIN_ARCH, cfg)
    batches = _train_batches(cfg, TRAIN_T, TRAIN_STEPS)
    step = make_train_step(cfg, TRAIN_OPT, device="cuda")
    _reset_launches()
    total = {name: 0 for name in KERNELS}
    live = None
    for i, batch in enumerate(batches, 1):
        if i == TRAIN_STEPS:
            live = _save_and_restore(params, opt_state)
        params, opt_state = _timed_step(cfg, step, params, opt_state, batch,
                                        i, total)
        if i == 1:
            _check_against_plain(cfg, params, batches[1], names)
    _peak_memory("[train]", TRAIN_ARCH, f"init and {TRAIN_STEPS} steps")
    # step 3 again from the restored state: bit for bit
    r_params, r_state = live
    _decode_from(cfg, r_params, batches[0])
    _profile_train_step(f"{TRAIN_ARCH} train step T={TRAIN_T}",
                        lambda: step(r_params, r_state, batches[-1]))
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves({"p": params, "s": opt_state}),
        tree_leaves({"p": r_params, "s": r_state}), strict=True))
    gap = max((a.float() - b.float()).abs().max().item() for a, b in zip(
        tree_leaves(params), tree_leaves(r_params), strict=True))
    print(f"[train] step {TRAIN_STEPS} from the restored checkpoint vs from "
          f"the live state: params and optimizer state bit-identical: "
          f"{same} (largest param gap {gap:.3g})")
    if not same:
        raise AssertionError(f"resume not bit-identical: gap {gap}")
    del params, opt_state, r_params, r_state, live
    gc.collect()
    torch.cuda.empty_cache()
    _check_card_vs_cpu(cfg)
    return total


XLSTM_ARCH = "xlstm-1.3b"
XLSTM_STEPS = 2
# one full-width superblock (7 mLSTM + 1 sLSTM) where a check needs a
# second copy of the state (the whole model's state is 56 GB with its
# gradients and moments); card vs CPU at its last two layers (1 + 1)
XLSTM_SUPERBLOCK = ((0, tuple(range(8)), 1),)
XLSTM_CPU_CUT = ((0, (6, 7), 1),)


def phase_train_xlstm() -> dict[str, int]:
    """The whole full-width xlstm-1.3b trains XLSTM_STEPS steps at T=4096
    (batch 1), recompute on (one superblock a repeat): exact launches (the
    sLSTM scan twice, in its saving mode, and its backward once a sLSTM
    layer a step; no flash), finite loss and gradient norm, step times,
    peak memory under 80 GB; a ``[profile]`` of one more step.  Then, the
    whole model freed, the checks that need a second copy of the state at
    one full-width superblock (:func:`_check_superblock`), and 1 mLSTM + 1
    sLSTM layer at T=256 against the CPU.  Returns the launches of the
    XLSTM_STEPS steps."""
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, _ = _init_train(XLSTM_ARCH, cfg)
    batches = _train_batches(cfg, TRAIN_T, XLSTM_STEPS + 1)
    step = make_train_step(cfg, TRAIN_OPT, device="cuda")
    _reset_launches()
    total = {name: 0 for name in KERNELS}
    for i, batch in enumerate(batches[:XLSTM_STEPS], 1):
        params, opt_state = _timed_step(cfg, step, params, opt_state, batch,
                                        i, total)
    _peak_memory("[train]", XLSTM_ARCH, f"init and {XLSTM_STEPS} steps")
    before = _launches()
    _profile_train_step(f"{XLSTM_ARCH} train step T={TRAIN_T} (step "
                        f"{XLSTM_STEPS + 1})",
                        lambda: step(params, opt_state, batches[-1]))
    _reset_from(before)
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    _check_superblock(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    _check_card_vs_cpu(cfg, XLSTM_CPU_CUT)
    return total


@contextmanager
def _plain_slstm_autograd():
    """``slstm_scan``'s autograd path with the plain forward (saving) and
    backward in place of the kernels (no launch counted).  Autograd of the
    plain forward itself would keep a copy of R a step: 68 GB at T=4096."""
    fwd, bwd = slstm_ops.slstm_scan_saving, slstm_ops.slstm_scan_bwd
    slstm_ops.slstm_scan_saving = lambda wx, r, b, state, n_cta: \
        slstm_scan_saving_ref(wx, r, b, state)
    slstm_ops.slstm_scan_bwd = lambda *a, wx_dtype, n_cta: \
        slstm_scan_bwd_ref(*a, wx_dtype=wx_dtype)
    try:
        yield
    finally:
        slstm_ops.slstm_scan_saving, slstm_ops.slstm_scan_bwd = fwd, bwd


def _check_superblock(cfg) -> None:
    """One full-width superblock at T=4096: the gradients twice with the
    kernels, bit-identical (in place of a resume check, which would need
    a second 56 GB state), and against the same step with the sLSTM plain
    forward and backward on the card, at TRAIN_GRAD_TOL."""
    cut = _cut(cfg, XLSTM_SUPERBLOCK)
    params, _ = init_train_state(cut, 0, TRAIN_OPT, device="cuda")
    names = list(_leaf_names(params))
    batch, = _train_batches(cut, TRAIN_T, 1)
    before = _launches()
    loss, got = _grads(cut, params, batch)
    loss_again, again = _grads(cut, params, batch)
    after = _launches()
    same = torch.equal(loss, loss_again) and all(
        torch.equal(a, b) for a, b in zip(got, again, strict=True))
    print(f"[train] {cfg.name} one superblock ({_kinds(cut)}), T={TRAIN_T}: "
          f"the same gradients twice with the kernels: {len(names)} leaves "
          f"and the loss bit-identical: {same}")
    if not same:
        raise AssertionError("superblock gradients differ between two runs")
    del again
    ran = {k: after[k] - before[k] for k in after}
    if ran != _expected_train_launches(cut, 2):
        raise AssertionError(f"superblock launches {ran}")
    with _plain_slstm_autograd():
        want_loss, want = _grads(cut, params, batch)
    if _launches() != after:
        raise AssertionError("the plain sLSTM run launched a kernel")
    print(f"[train] {cfg.name} one superblock, kernels vs the sLSTM plain "
          f"forward and backward on the card: loss {loss.item():.7f} vs "
          f"{want_loss.item():.7f}")
    _compare_grads("superblock, kernels vs plain sLSTM on the card", names,
                   got, want)
    _reset_from(before)


def _save_and_restore(params: dict, opt_state: dict) -> tuple:
    """The state saved to CKPT_DIR and restored into fresh tensors."""
    state = {"params": params, "opt_state": opt_state}
    t0 = time.perf_counter()
    store.save(str(CKPT_DIR), state, {"arch": TRAIN_ARCH})
    t1 = time.perf_counter()
    back = store.restore(str(CKPT_DIR), state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_bytes = sum(p.numel() * p.element_size() for p in tree_leaves(state))
    if any(a.data_ptr() == b.data_ptr() for a, b in zip(
            tree_leaves(state), tree_leaves(back))):
        raise AssertionError("restore returned the live tensors")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                  tree_leaves(back)))
    print(f"[train] checkpoint after step {TRAIN_STEPS - 1}: "
          f"{n_bytes / 1e9:.2f} GB saved in {t1 - t0:.2f} s, restored in "
          f"{t2 - t1:.2f} s; restored equal to the live state: {same}")
    if not same:
        raise AssertionError("restored state differs from the saved one")
    shutil.rmtree(CKPT_DIR)
    return back["params"], back["opt_state"]


def _check_against_plain(cfg, params: dict, batch: dict, names) -> None:
    """The gradients at this state with the kernels against those with the
    plain flash forward and backward on the card."""
    before = _launches()
    loss, got = _grads(cfg, params, batch)
    after = _launches()
    with _plain_flash_autograd():
        want_loss, want = _grads(cfg, params, batch)
    if _launches() != after or after == before:
        raise AssertionError("the plain run launched a kernel, or the "
                             "kernel run none")
    print(f"[train] gradients after step 1, kernels vs plain flash on the "
          f"card: loss {loss.item():.7f} vs {want_loss.item():.7f}")
    _compare_grads("kernels vs plain flash on the card", names, got, want)
    _reset_from(before)


def _reset_from(counts: dict) -> None:
    for name, fn in KERNELS.items():
        fn.launches = counts[name]


def _decode_from(cfg, params: dict, batch: dict) -> None:
    """8 greedy tokens after a 16-token prompt with the prefill and serve
    steps, exact launches from the host, and the logits against the plain
    attention on the card."""
    prompt = {"tokens": torch.as_tensor(batch["tokens"][:, :PROMPT_LEN],
                                        dtype=torch.long)}
    before = _launches()
    prefills, tokens = [0, 0], [0, 0]
    pre = _counted(make_prefill_step(cfg, CACHE_LEN, device="cuda"),
                   prefills)
    srv = _counted(make_serve_step(cfg, device="cuda"), tokens)
    tok, caches = pre(params, prompt)
    out = [int(tok[0])]
    tok = tok[:, None]
    for i in range(MODEL_TOKENS):
        tok, caches = srv(params, caches, tok, PROMPT_LEN + i)
        out.append(int(tok[0, 0]))
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launches().items()}
    replays = (prefills[1], tokens[1])
    print(f"[train] greedy decode from the restored weights: {out}; "
          f"{replays[0]} prefill and {replays[1]} decode steps replayed "
          "from CUDA graphs; launches from the host "
          + ", ".join(f"{k}={v}" for k, v in launches.items()))
    _check_eager_launches("[train] greedy decode", cfg, launches, 1,
                          MODEL_TOKENS, replays)
    if not all(0 <= t < cfg.vocab_size for t in out):
        raise AssertionError(f"decoded tokens out of range: {out}")
    decode = torch.as_tensor([out[:-1]])
    with torch.inference_mode():
        got = _logits(cfg, params, prompt, "cuda", decode=decode)
        with _plain_attention():
            want = _logits(cfg, params, prompt, "cuda", decode=decode)
    _compare_logits("[train]", f"{cfg.name} restored weights, kernels vs "
                    "plain on the card", got, want)
    if [int(g[0, -1, :cfg.vocab_size].argmax()) for g in got] != out:
        raise AssertionError("greedy tokens disagree with the logits")
    _reset_from(before)


# --------------------------------------------------------------------------- #
# Phase 7: head padding                                                       #
# --------------------------------------------------------------------------- #


PAD_ARCH = "qwen2-0.5b"
PAD_MULTIPLES = (8, 16)               # 14/2 heads -> 16/8 (G=2), 16/16 (G=1)


def _outcomes(reqs) -> list:
    """Each request's final state and tokens, in submission order (request
    ids run on across engines)."""
    return [(r.state, list(r.tokens_out)) for r in reqs]


def _serving_ms(cfg, params, batch: dict) -> tuple[float, float]:
    """Device ms of one prefill of ``batch`` and one decode step after it
    (CUDA-graph replay)."""
    pre = make_prefill_step(cfg, CACHE_LEN, device="cuda")
    srv = make_serve_step(cfg, device="cuda")
    nxt, caches = pre(params, batch)
    last = nxt[:, None]
    return (device_ms(lambda: pre(params, batch), calls=3, reps=3),
            device_ms(lambda: srv(params, caches, last, PROMPT_LEN),
                      calls=3, reps=3))


def phase_pad() -> None:
    """Full-width qwen2-0.5b with its heads padded (``pad_heads_config``,
    weights from ``pad_attn_params`` of the unpadded ones) to multiples of
    8 and 16, served through the engine: both attention kernels run at
    the padded heads, the logits stay within the card tolerance of the
    unpadded model's, the request mix's outcomes are the unpadded run's
    (the same cost model sets the slots of both), and as many steps run,
    each launching the kernels an unpadded one launches."""
    cfg = get_config(PAD_ARCH)
    cost = measure_cost_model(cfg, prompt_len=PROMPT_LEN,
                              cache_len=CACHE_LEN, reps=3, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                                     generator=gen, device="cuda")}
    decode = torch.randint(0, cfg.vocab_size, (1, MODEL_TOKENS),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        want = _logits(cfg, params, batch, "cuda", decode=decode)
    base_ms = _serving_ms(cfg, params, batch)
    reqs, _, base_launches, prefills, tokens, _, base_replays = \
        _engine_run(cfg, params, cost)
    _check_eager_launches(f"[pad] {cfg.name}", cfg, base_launches, prefills,
                          tokens, base_replays)
    base = _outcomes(reqs)
    print(f"[pad] {cfg.name} unpadded H={cfg.n_heads} KV={cfg.n_kv_heads}: "
          f"{sum(r.state == 'done' for r in reqs)}/{len(reqs)} requests "
          f"done; prefill {base_ms[0]:.5f} ms, decode {base_ms[1]:.5f} ms "
          "(device, graph replay)")
    for mult in PAD_MULTIPLES:
        cfg_p = pad_heads_config(cfg, mult)
        params_p = pad_attn_params(params, cfg, cfg_p)
        g = cfg_p.n_heads // cfg_p.n_kv_heads
        label = (f"{cfg.name} padded to {mult} (H={cfg_p.n_heads} "
                 f"KV={cfg_p.n_kv_heads} G={g})")
        with torch.inference_mode():
            got = _logits(cfg_p, params_p, batch, "cuda", decode=decode)
        _compare_logits("[pad]", f"{label} vs unpadded", got, want)
        ms = _serving_ms(cfg_p, params_p, batch)
        reqs, _, launches, n_pre, n_tok, wall, replays = _engine_run(
            cfg_p, params_p, cost)
        print(f"[pad] {label}: engine run {wall:.2f} s wall, "
              f"{sum(r.state == 'done' for r in reqs)}/{len(reqs)} requests "
              f"done; launches " + ", ".join(
                  f"{k}={v}" for k, v in launches.items() if v)
              + f"; prefill {ms[0]:.5f} ms ({ms[0] / base_ms[0]:.3f}x "
              f"unpadded), decode {ms[1]:.5f} ms ({ms[1] / base_ms[1]:.3f}x)"
              " (device, graph replay)")
        diff = [(i, got, want) for i, (got, want) in
                enumerate(zip(_outcomes(reqs), base)) if got != want]
        if diff:
            raise AssertionError(f"{label}: request outcomes differ from "
                                 f"the unpadded run's at {diff[:3]}")
        _check_eager_launches(f"[pad] {label}", cfg_p, launches, n_pre,
                              n_tok, replays)
        if (n_pre, n_tok) != (prefills, tokens):
            raise AssertionError(f"{label}: {n_pre} prefills and {n_tok} "
                                 f"decode steps, unpadded {prefills} and "
                                 f"{tokens}")
        del params_p
    _peak_memory("[pad]", cfg.name, "unpadded and padded weights, engine "
                 "runs")


# --------------------------------------------------------------------------- #
# Phase 8: the DTensor path on a one-card mesh                                #
# --------------------------------------------------------------------------- #


SHARD_ARCH = "qwen2-0.5b"
SHARD_TRAIN_T = 1024
SHARD_STEP_TOL = 1e-2       # params after a step, of each leaf's max |x|


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _diff(label: str, got, want, tol: float) -> None:
    """Print whether ``got`` (DTensors) and ``want`` are bit-identical,
    else their largest difference relative to ``want``'s largest |x|;
    raise above ``tol``."""
    worst, where = 0.0, ""
    same = True
    for (name, g), (_, w) in zip(got, want, strict=True):
        g = g.full_tensor() if hasattr(g, "full_tensor") else g
        same &= torch.equal(g, w)
        if not torch.isfinite(g).all():
            raise AssertionError(f"[shard] {label}: {name} not finite")
        rel = (g.float() - w.float()).abs().max().item() / max(
            w.float().abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    print(f"[shard] {label}: " + ("bit-identical" if same else
          f"largest max|diff| / max|x| {worst:.3g} at {where}")
          + f" ({len(want)} tensors; tol {tol:g})")
    if worst > tol:
        raise AssertionError(f"[shard] {label} differs by {worst:.3g}")


def _sharded_serving(cfg, params, mesh, batch: dict, decode) -> tuple:
    """One prefill and a decode step per token of ``decode`` on the
    params as DTensors (the dry run's rules, its cache rules): the logits
    of each, and the greedy tokens of the prefill and serve steps."""
    from torch.distributed.tensor.experimental import implicit_replication

    with torch.inference_mode():
        dparams = S.distribute_tree(params, M.params_axes(cfg), mesh)
        rules = S.cache_batch_rules(mesh, 1, prefer_seq_shard=True)
        caches = S.distribute_tree(
            M.init_caches(cfg, 1, CACHE_LEN, device="cuda"),
            M.caches_axes(cfg), mesh, rules)
        tok = S.distribute(batch["tokens"], ("data", None), mesh)
        dec = S.distribute(decode, ("data", None), mesh)
        with implicit_replication():
            pre, caches = M.prefill(dparams, cfg, {"tokens": tok},
                                    CACHE_LEN, caches=caches)
            logits = [pre]
            for i in range(decode.shape[1]):
                out, _ = M.decode_step(dparams, cfg, caches,
                                       dec[:, i:i + 1], PROMPT_LEN + i)
                logits.append(out)
            pre_step = make_prefill_step(cfg, CACHE_LEN, device="cuda")
            step_tok, caches = pre_step(
                dparams, {"tokens": tok},
                S.distribute_tree(M.init_caches(cfg, 1, CACHE_LEN,
                                                device="cuda"),
                                  M.caches_axes(cfg), mesh, rules))
            srv = make_serve_step(cfg, device="cuda")
            toks = [step_tok]
            for i in range(decode.shape[1]):
                nxt, caches = srv(dparams, caches, dec[:, i:i + 1],
                                  PROMPT_LEN + i)
                toks.append(nxt[:, 0])
    return [x.full_tensor().float() for x in logits], \
        [int(t.full_tensor()[0]) for t in toks]


def phase_shard() -> None:
    """Full-width qwen2-0.5b on DTensors over a real one-card mesh (NCCL,
    world size 1, (1, 1) over ("data", "model")), placed by the sharding
    rules: one prefill and 8 decode tokens, then one train step at
    T=1024, each through the hand-written kernels and held against the
    plain tensors' run."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh()
        cfg = get_config(SHARD_ARCH)
        print(f"[shard] {cfg.name} on {mesh}: params placed by the rules "
              "(FSDP gathers, vocab-parallel embedding and loss, kernels "
              "through local_map)")
        params = M.init_params(cfg, 0, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                                         generator=gen, device="cuda")}
        decode = torch.randint(0, cfg.vocab_size, (1, MODEL_TOKENS),
                               generator=gen, device="cuda")
        with torch.inference_mode():
            want = [x.cuda() for x in _logits(cfg, params, batch, "cuda",
                                               decode=decode)]
            pre = make_prefill_step(cfg, CACHE_LEN, device="cuda")
            srv = make_serve_step(cfg, device="cuda")
            nxt, caches = pre(params, batch)
            plain_toks = [int(nxt[0])]
            for i in range(MODEL_TOKENS):
                nxt, caches = srv(params, caches, decode[:, i:i + 1],
                                  PROMPT_LEN + i)
                plain_toks.append(int(nxt[0, 0]))
        _reset_launches()
        got, toks = _sharded_serving(cfg, params, mesh, batch, decode)
        torch.cuda.synchronize()
        launches = _launches()
        print("[shard] serving on DTensors: launches " + ", ".join(
            f"{k}={v}" for k, v in launches.items() if v))
        if not launches["flash_attention"] or \
                not launches["decode_attention"]:
            raise AssertionError(f"[shard] serving launches {launches}")
        names = ["prefill"] + [f"decode {i + 1}" for i in
                               range(MODEL_TOKENS)]
        _diff("logits, DTensors vs plain tensors", list(zip(names, got)),
              list(zip(names, want)), LOGIT_TOL)
        print(f"[shard] greedy tokens: DTensors {toks}, plain {plain_toks}")
        if toks != plain_toks:
            raise AssertionError("[shard] greedy tokens differ")
        del params, caches
        _shard_train(cfg, mesh)
    finally:
        dist.destroy_process_group()


def _shard_train(cfg, mesh) -> None:
    """One AdamW step at T=SHARD_TRAIN_T on DTensors (params, moments and
    batch placed by the rules) against the same step on plain tensors:
    loss, every gradient, the updated params."""
    from torch.distributed.tensor.experimental import implicit_replication

    batch = next(train_batches(cfg, InputShape("shard", SHARD_TRAIN_T, 1,
                                               "train")))
    batch = {k: torch.as_tensor(v).long().cuda() for k, v in batch.items()}
    params, opt_state = init_train_state(cfg, 0, TRAIN_OPT, device="cuda")
    names = list(_leaf_names(params))
    loss, _, grads = loss_and_grads(params, cfg, batch)
    step = make_train_step(cfg, TRAIN_OPT, device="cuda")
    params, opt_state, metrics = step(params, opt_state, batch)
    want = {"loss": loss, "grads": list(tree_leaves(grads)),
            "params": [p.detach() for p in tree_leaves(params)],
            "grad_norm": metrics["grad_norm"]}
    del params, opt_state, grads
    gc.collect()
    dparams, dopt = init_train_state(cfg, 0, TRAIN_OPT, device="cuda")
    axes = M.params_axes(cfg)
    dparams = S.distribute_tree(dparams, axes, mesh)
    dopt = {"m": S.distribute_tree(dopt["m"], axes, mesh),
            "v": S.distribute_tree(dopt["v"], axes, mesh),
            "step": S.distribute(dopt["step"], (), mesh)}
    dbatch = {k: S.distribute(v, ("data", None), mesh)
              for k, v in batch.items()}
    _reset_launches()
    t0 = time.perf_counter()
    with implicit_replication():
        dloss, _, dgrads = loss_and_grads(dparams, cfg, dbatch)
        dparams, dopt, dmetrics = step(dparams, dopt, dbatch)
    torch.cuda.synchronize()
    launches = _launches()
    print(f"[shard] train at T={SHARD_TRAIN_T} on DTensors (gradients, "
          f"then one AdamW step) in {time.perf_counter() - t0:.2f} s: "
          "launches " + ", ".join(f"{k}={v}" for k, v in launches.items()
                                  if v))
    if launches != {k: 2 * v for k, v in
                    _expected_train_launches(cfg, 1).items()}:
        raise AssertionError(f"[shard] train launches {launches}")
    print(f"[shard] loss: DTensors {dloss.full_tensor().item():.7f}, plain "
          f"{want['loss'].item():.7f}; grad_norm "
          f"{dmetrics['grad_norm'].full_tensor().item():.7f} vs "
          f"{want['grad_norm'].item():.7f}")
    _diff("loss", [("loss", dloss)], [("loss", want["loss"])], 1e-5)
    _diff("gradients, DTensors vs plain tensors",
          list(zip(names, tree_leaves(dgrads))),
          list(zip(names, want["grads"])), TRAIN_GRAD_TOL)
    # AdamW divides each gradient by its own root mean square: where |g|
    # is near eps (the zero-initialised biases) the gradients' 1e-6
    # relative rounding moves the update by up to about 1 % of lr
    _diff("params after the step, DTensors vs plain tensors",
          list(zip(names, (p.detach() for p in tree_leaves(dparams)))),
          list(zip(names, want["params"])), SHARD_STEP_TOL)
    _peak_memory("[shard]", cfg.name, "plain and DTensor runs")


# --------------------------------------------------------------------------- #
# Phase 9: the dry run                                                        #
# --------------------------------------------------------------------------- #


# (dry-run arguments) run in turn: every step kind and both meshes
DRYRUN_SUBSET = (("--arch", "qwen2-0.5b"),
                 ("--arch", "xlstm-1.3b", "--shape", "train_4k"),
                 ("--arch", "deepseek-v3-671b", "--shape", "decode_32k",
                  "--multi-pod"))
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun_smoke.jsonl"


def phase_dryrun() -> None:
    """``python -m repro_torch.launch.dryrun`` over a subset that covers
    each step kind and both production meshes, each as a subprocess (its
    ``fake`` process group never meets this process's), all started
    together; fails if any combo fails."""
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    runs = []
    t0 = time.perf_counter()
    try:
        for i, args in enumerate(DRYRUN_SUBSET):
            out = DRYRUN_OUT.with_suffix(f".{i}.jsonl")
            log = DRYRUN_OUT.with_suffix(f".{i}.log")
            out.unlink(missing_ok=True)
            with open(log, "w") as fh:      # files, not pipes: none waits
                runs.append((args, out, log, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     *args, "--out", str(out)],
                    cwd=Path(__file__).resolve().parent, stdout=fh,
                    stderr=subprocess.STDOUT, text=True)))
        for args, out, log, proc in runs:
            proc.wait(timeout=600)
            text = log.read_text()
            for line in text.splitlines():
                if line.startswith("[dryrun]"):
                    print(line)
            print(f"[dryrun] {' '.join(args)}: exit {proc.returncode} "
                  f"within {time.perf_counter() - t0:.1f} s of the start")
            if proc.returncode != 0:
                raise AssertionError(f"dry run {args} failed:\n"
                                     f"{text[-3000:]}")
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    DRYRUN_OUT.write_text("".join(out.read_text() for _, out, _, _ in runs))
    for line in DRYRUN_OUT.read_text().splitlines():
        rec = json.loads(line)
        roof = rec["roofline"]
        print(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"per device {rec['argument_size_in_bytes']} argument bytes, "
              f"{rec['output_size_in_bytes']} output, peak live "
              f"{rec['argument_size_in_bytes'] + rec['temp_size_in_bytes']}"
              f"; {roof['flops_per_device']:.4g} FLOPs, "
              f"{roof['hbm_bytes_per_device']:.4g} bytes, "
              f"{roof['collective_bytes_per_device']:.4g} wire bytes in "
              f"{roof['n_collectives']} collectives "
              f"{json.dumps(roof['collectives_by_kind'])}; bottleneck "
              f"{roof['bottleneck']}; kernels {json.dumps(rec['kernels'])}")



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
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels()
    print(f"[time] build and kernels: {time.perf_counter() - t0:.1f} s")
    # the kernels line carries the launches of the main path's engine run
    # of each kernel: qwen2's for the attention kernels, xLSTM's for the
    # sLSTM scan (the first served model that runs it); the backward
    # kernels those of their train steps (qwen2's, xLSTM's); the standalone
    # halo conv block carries those of its own phase.  ``launches`` are
    # those made from the host, ``replayed_launches`` those that the
    # serving steps' CUDA graphs ran (see _replayed_launches)
    launches, replayed = {}, {}
    for arch, keep, cpu_cut in SERVED:
        t1 = time.perf_counter()
        eager, graphed = phase_serve(arch, keep, cpu_cut)
        for name, n in eager.items():
            if n or graphed.get(name):
                launches.setdefault(name, n)
                replayed.setdefault(name, graphed.get(name, 0))
        gc.collect()                        # free this model before the next
        torch.cuda.empty_cache()
        print(f"[time] serve {arch}: {time.perf_counter() - t1:.1f} s")
    for name, phase in (("churn", phase_churn), ("sim", phase_sim)):
        t1 = time.perf_counter()
        phase()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] {name}: {time.perf_counter() - t1:.1f} s")
    for arch, keep, cpu_cut in MODELS:
        t1 = time.perf_counter()
        phase_model(arch, keep, cpu_cut)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[time] model {arch}: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    # the backward kernels' launches are those of the train steps
    launches["flash_attention_bwd"] = phase_train()["flash_attention_bwd"]
    print(f"[time] train {TRAIN_ARCH}: {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    launches["slstm_scan_bwd"] = phase_train_xlstm()["slstm_scan_bwd"]
    print(f"[time] train {XLSTM_ARCH}: {time.perf_counter() - t1:.1f} s")
    for name, phase in (("pad", phase_pad), ("shard", phase_shard),
                        ("dryrun", phase_dryrun)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()    # each phase's own peak
        t1 = time.perf_counter()
        phase()
        print(f"[time] {name}: {time.perf_counter() - t1:.1f} s")
    print(f"[time] total: {time.perf_counter() - t0:.1f} s")
    kernels = [dict({"launches": launches.get(name, 0),
                     "replayed_launches": replayed.get(name, 0)},
                    **rows[name])
               for name in sorted(rows)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
