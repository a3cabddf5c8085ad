"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines of standard error repeat.  Exits non-zero and prints
no result without enough CUDA cards, without the port beside the
benchmark, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()         # set-up counts from the process start

import argparse                        # noqa: E402
import sys                             # noqa: E402
from pathlib import Path               # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import bench            # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench.cache_env()
    cell = bench.load_cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the port (repro_torch) is not beside the benchmark: {e}",
              file=sys.stderr)
        return 2
    # the configuration states f32: full f32 products, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = cell.traffic["kind"]
    if kind == "serve":
        from portbench import serve as driver
    elif kind == "train":
        from portbench import train as driver
    else:
        print(f"unknown traffic kind {kind!r}", file=sys.stderr)
        return 2
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START, device="cuda")
    res, checks = out["result"], out["checks"]
    bad = bench.loaded_forbidden()
    if bad:
        print(f"modules that may not load were loaded: {bad}",
              file=sys.stderr)
        return 4
    info = res.pop("info")
    print(f"info {info}", file=sys.stderr)
    result = {k: res[k] for k in ("correct", "attempted", "failed",
                                  "metrics")}
    result["device"] = bench.device_info(
        torch, chips, res["peak"],
        None if res["trace"] is None else
        {"busy_s": res["trace"].busy_s, "window_s": res["trace"].window_s})
    if "breakdown" in res:
        result["breakdown"] = res["breakdown"]
    bench.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
