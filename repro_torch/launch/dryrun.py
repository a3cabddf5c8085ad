"""Multi-pod dry run: run every (architecture x input shape) step once on
the production meshes, on abstract shards, and record per-device memory,
cost and collectives.

Port of the JAX package's ``launch/dryrun.py``.  One process stands for
every rank: the default process group is ``torch.distributed``'s ``fake``
backend at the mesh's world size (256 or 512), and the tensors are
``meta`` DTensors: nothing is allocated.  The mesh's device type is
"cuda" unless ``--mesh-device cpu`` asks for a machine without a card.
Each combo is built by ``build.build_combo``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
      --out results/dryrun.jsonl

Record keys follow the JAX dry run's where they mean the same; ``build_s``
replaces ``lower_s`` and ``compile_s``; ``temp_size_in_bytes`` is the peak
of live local bytes above the arguments (an estimate, counted by storage);
JAX's ``--unroll`` has no counterpart (every layer is run and counted).
Exits 1 unless every combo is ok.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from ..configs import ARCH_IDS
from ..configs.shapes import SHAPES
from ..models.sharding import RuleSet
from .build import build_combo
from .mesh import make_production_mesh, production_shape


def _init_fake_group(world_size: int) -> None:
    # the fake backend lives in torch's internal testing package; only the
    # dry run uses it
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_one(arch: str, shape_name: str, mesh, multi_pod: bool,
            verbose: bool = True, **combo_kw) -> dict:
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "multi_pod": multi_pod,
        "chips": mesh.size(),
    }
    t0 = time.time()
    try:
        combo = build_combo(arch, shape_name, mesh, **combo_kw)
        rec["build_s"] = round(time.time() - t0, 1)
        rec["argument_size_in_bytes"] = combo.argument_bytes
        rec["output_size_in_bytes"] = combo.output_bytes
        rec["temp_size_in_bytes"] = max(0, combo.peak_bytes
                                        - combo.argument_bytes)
        rec["total_bytes_per_device"] = sum(
            rec[a] for a in ("argument_size_in_bytes", "temp_size_in_bytes",
                             "output_size_in_bytes"))
        rec["roofline"] = combo.roofline.summary()
        rec["kernels"] = {name: calls for name, (calls, _, _)
                          in combo.kernels.items()}
        rec["status"] = "ok"
    except Exception as e:                  # noqa: BLE001 (one combo's fault)
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    if verbose:
        status = rec["status"]
        extra = (f"bottleneck={rec['roofline']['bottleneck']} "
                 f"bytes/device={rec['total_bytes_per_device']:.4g}"
                 if status == "ok" else rec.get("error", "")[:120])
        print(f"[dryrun] {arch:24s} {shape_name:12s} "
              f"mesh={rec['mesh']:8s} {status:4s} "
              f"({rec['total_s']:.0f}s) {extra}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--baseline", action="store_true",
                    help="divisibility-only sharding (no sequence-shard "
                    "cache fallback)")
    ap.add_argument("--mesh-device", default="cuda", choices=("cuda", "cpu"),
                    help="the meshes' device type; the shards are meta "
                    "tensors either way, so 'cpu' runs without a card")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    # explicit --arch/--shape filters always win; --all (or omission)
    # sweeps the unfiltered axis
    archs = (args.arch,) if args.arch else ARCH_IDS
    shapes = (args.shape,) if args.shape else tuple(SHAPES)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    ruleset = RuleSet(seq_shard_cache_fallback=not args.baseline)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    out_f = open(args.out, "a") if args.out else None
    n_ok = n = 0
    t0 = time.time()
    try:
        for mp in meshes:
            shape, _ = production_shape(mp)
            _init_fake_group(math.prod(shape))
            mesh = make_production_mesh(multi_pod=mp,
                                        device_type=args.mesh_device)
            for arch in archs:
                for shape_name in shapes:
                    rec = run_one(arch, shape_name, mesh, mp,
                                  dtype=args.dtype, ruleset=ruleset)
                    rec["dtype"] = args.dtype
                    rec["baseline_rules"] = args.baseline
                    n_ok += rec["status"] == "ok"
                    n += 1
                    if out_f:
                        slim = {k: v for k, v in rec.items()
                                if k != "traceback"}
                        out_f.write(json.dumps(slim) + "\n")
                        out_f.flush()
                    if rec["status"] != "ok":
                        print(rec["traceback"], file=sys.stderr, flush=True)
                    gc.collect()
    finally:
        if out_f:
            out_f.close()
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[dryrun] {n_ok}/{n} combos built OK in {time.time() - t0:.1f} s")
    if n_ok != n:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
