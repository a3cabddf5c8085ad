"""Readings that set the limits of ``correct``, on the card at a cell's own
size, many seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out FILE]

Serving cells: for each seed, the weights and a short window at the cell's
load (the ``check.episodes`` episodes that hold the judged sample), then the
reference's widest gap below its best logit of the served tokens (the
program's reading) and, on the control seeds, of the tokens that the
reference computed in TF32 puts first at the same positions (the
control's reading).

Training cells: for each seed, the program's first steps against the
reference (the program's readings); on the control seeds also the
reference in TF32 against the reference, and the program with half of each
batch left out against the reference (a fault's readings).  A step that
returns its state unchanged reads 1 in the gradient and change numbers
without a run.

The benchmark's own runs never run this.  Each reading is one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench  # noqa: E402


def serve_readings(cell, seed: int, control: bool, costs,
                   fault: str | None = None) -> dict:
    import torch
    from portbench import serve
    sr = serve.ServeRun(cell, seed, "cuda", fault=fault)
    sr.setup(costs=costs)
    sr.episodes = cell.traffic["check"]["episodes"]
    for e in range(sr.episodes):
        sr.episode(e)
    sample = sr.sample()
    sr.free_program(keep=sample)
    t0 = time.perf_counter()
    gaps, kv = serve.judge(sr.ref, sr.weights, sr.dims, sample, sr.kv)
    row = {"seed": seed, "fault": fault, "judged": len(sample),
           "of": len(sr.watch),
           "positions": len(gaps),
           "program_gap": max(gaps), "program_kv_rel_err": max(kv),
           "program_nonzero": sum(g > 0 for g in gaps),
           "reference_s": round(time.perf_counter() - t0, 3)}
    if control:
        gaps, kv = serve.judge(sr.ref, sr.weights, sr.dims, sample, sr.kv,
                               "tf32", control=True)
        row.update(control_gap=max(gaps), control_kv_rel_err=max(kv),
                   control_nonzero=sum(g > 0 for g in gaps))
    del sr
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_readings(cell, seed: int, control: bool) -> dict:
    import torch
    from portbench import train
    row = {"seed": seed}

    def program(fault):
        cfg, p, s, step, batches = train.program(cell, seed, "cuda", fault)
        seen, got = train.first_steps(
            p, s, step, batches, cell.traffic["check"]["steps"],
            cell.traffic["optimizer"]["b1"], torch.device("cuda"))
        del p, s, step
        gc.collect()
        torch.cuda.empty_cache()
        return seen, got

    seen, prog = program(None)
    ref = train.reference(cell, seed, "cuda", seen)
    gc.collect()
    torch.cuda.empty_cache()
    row["program"] = {k: v for k, v in train.compare(prog, ref).items()}
    if control:
        low = train.reference(cell, seed, "cuda", seen, "tf32")
        row["control"] = train.compare(low, ref)
        _, half = program("half")
        row["half_batch"] = train.compare(half, ref)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description="the readings of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="serving: seeds run with a token altered where "
                         "the prefill produces it")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    bench.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = bench.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    costs = None
    if cell.traffic["kind"] == "serve":
        from portbench import serve
        sr = serve.ServeRun(cell, (seeds + faults)[0], "cuda")
        sr.setup()
        costs = sr.costs
        del sr
    sink = open(args.out, "a") if args.out else None
    runs = [(s, None) for s in seeds + sorted(ctl - set(seeds))]
    runs += [(s, "token") for s in faults]
    for seed, fault in runs:
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "serve":
            row = serve_readings(cell, seed, seed in ctl and not fault,
                                 costs, fault)
        else:
            row = train_readings(cell, seed, seed in ctl)
        row["workload"] = args.workload
        row["seconds"] = round(time.perf_counter() - t0, 3)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
