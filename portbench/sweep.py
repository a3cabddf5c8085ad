"""Find a serving cell's knee once, on the card, and freeze its traffic.

    python3 portbench/sweep.py --workload <name> --seed <n> [--out DIR]
        [--commit TEXT]

1. Measures the slot table at every prompt length of the traffic with the
   port's ``measure_cost_model`` (as a run's set-up does).
2. Freezes the deadlines from it: an HP request's is twice its length's
   padded prefill plus 50 ms, an LP request's three times its execution
   time at degree 2 (the rules of the paper-mix example).
3. Sweeps the Poisson rate (requests a second of the engine's clock) over
   a geometric grid.  The engine's outcomes on its clock do not depend on
   what the compute returns, only on the slots, so the sweep runs the
   engine with its compute replaced by a stub.  The knee is the highest
   rate up to which every rate keeps ``hp_met_share`` at 0.99 or above and
   the LP work sustained.  The paper's scheduler keeps no queue that could
   grow: an LP request it cannot place before its deadline fails at once.
   So a backlog that does not grow reads here as at least 0.99 of the LP
   requests met (every LP request placed but one in a hundred), and a
   share of LP requests missed in an episode's second half of arrivals no
   more than 0.05 above the first half's.
4. Sets the rate to four fifths of the knee, times one episode of real
   compute there, and writes the traffic file (to ``--out`` where given)
   with the rate, the deadlines, the sweep's rows, the card, its power
   limit and ``--commit``.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench  # noqa: E402

GRID = [2.0 * 1.25 ** i for i in range(30)]
EPISODES = 8


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def frozen_deadlines(traffic: dict, costs: dict) -> None:
    for cls in traffic["classes"]:
        k = cls["new_tokens"]
        dl = {}
        for n in cls["prompt_lens"]:
            c = costs[n]
            if cls["priority"] == "high":
                dl[str(n)] = round(2.0 * c.prefill[1].padded + 0.05, 4)
            else:
                lp = c.prefill[1].mean_s + (k - 1) * c.decode[2].mean_s
                dl[str(n)] = round(3.0 * lp, 4)
        cls["deadline_s"] = dl


def schedule_at(cell, costs, rate: float, seed: int, device) -> dict:
    from portbench import serve
    c = copy.deepcopy(cell)
    c.traffic["arrivals"]["rate_per_s"] = rate
    sr = serve.ServeRun(c, seed, device, stub=True)
    sr.setup(costs=costs)
    growth = []
    for e in range(EPISODES):
        sr.episode(e)
        lp = sorted(((p["t"], r.state == "done") for ep, p, r in sr.requests
                     if ep == e and not p["hp"]))
        half = len(lp) // 2
        miss = [1 - sum(d for _, d in part) / max(len(part), 1)
                for part in (lp[:half], lp[half:])]
        growth.append(miss[1] - miss[0])
    sr.episodes = EPISODES
    out = sr.outcomes()
    return {"rate_per_s": round(rate, 4),
            "hp_met_share": out["hp_done"] / out["hp_sent"],
            "lp_met_share": out["lp_done"] / out["lp_sent"],
            "lp_miss_growth": sum(growth) / len(growth),
            "preemptions": sum(m.preemptions for m in sr.metrics)}


def main() -> int:
    ap = argparse.ArgumentParser(description="the knee of a serving cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--commit", default="unknown")
    args = ap.parse_args()
    bench.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import serve
    cell = bench.load_cell(args.workload)
    sr = serve.ServeRun(cell, args.seed, "cuda")
    t0 = time.perf_counter()
    sr.setup()
    print(f"set-up {time.perf_counter() - t0:.3f} s")
    costs = sr.costs
    table = {str(n): {"prefill_ms": 1e3 * c.prefill[1].mean_s,
                      "prefill_std_ms": 1e3 * c.prefill[1].std_s,
                      "decode_ms": 1e3 * c.decode[2].mean_s,
                      "decode_std_ms": 1e3 * c.decode[2].std_s}
             for n, c in sorted(costs.items())}
    for n, row in table.items():
        print(f"slot T={n}: {row}")
    frozen_deadlines(cell.traffic, costs)
    print("deadlines", [c["deadline_s"] for c in cell.traffic["classes"]])
    rows, knee = [], None
    for rate in GRID:
        row = schedule_at(cell, costs, rate, args.seed, "cuda")
        rows.append(row)
        print("sweep", json.dumps(row))
        if (row["hp_met_share"] < 0.99 or row["lp_met_share"] < 0.99
                or row["lp_miss_growth"] > 0.05):
            break
        knee = rate
    if knee is None:
        print("no rate of the grid holds", file=sys.stderr)
        return 1
    rate = 0.8 * knee
    cell.traffic["arrivals"]["rate_per_s"] = round(rate, 4)
    sr.traffic = cell.traffic
    sr.setup(costs=costs)
    t0 = time.perf_counter()
    sr.episode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"one episode of real compute at {rate:.4f}/s: {wall:.3f} s wall, "
          f"{sr.outcomes()['done_tokens']} tokens done")
    cell.traffic["sweep"] = {
        "card": card(), "commit": args.commit, "seed": args.seed,
        "knee_per_s": round(knee, 4), "rows": rows, "slots": table,
        "episode_wall_s": round(wall, 3)}
    out = Path(args.out) if args.out else bench.ROOT / "portbench"
    path = out / "traffic" / f"{cell.workload['traffic']}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cell.traffic, indent=2) + "\n")
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
