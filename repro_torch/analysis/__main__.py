"""CLI: ``python -m repro_torch.analysis [paths...] [--gate] [--json PATH]``.

Run from the repo root.  With no paths it scans ``<root>/repro_torch/``
only, against ``<root>/repro_torch/analysis/baseline.json``.

Exit codes: 0 clean (or report-only mode), 1 gate failure (unbaselined
findings or stale baseline entries), 2 usage/budget errors.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from .engine import default_rules, load_baseline, run_analysis

PACKAGE = "repro_torch"
BASELINE = Path(PACKAGE, "analysis", "baseline.json")


def _default_root() -> Path:
    # .../repro_torch/analysis/__main__.py -> the repo root
    return Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST-based invariant lint plane (replint) of the port")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to restrict the scan to "
                             "(default: <root>/repro_torch/)")
    parser.add_argument("--root", type=Path, default=None,
                        help="analysis root (default: the repo root "
                             "containing the repro_torch package)")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="baseline JSON (default: "
                             f"<root>/{BASELINE.as_posix()} when present)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule names to run "
                             "(default: all)")
    parser.add_argument("--gate", action="store_true",
                        help="exit 1 on any unbaselined finding or stale "
                             "baseline entry")
    parser.add_argument("--json", type=Path, default=None, metavar="PATH",
                        help="write the deterministic JSON report here")
    parser.add_argument("--budget-s", type=float, default=None,
                        help="fail (exit 2) if the run exceeds this many "
                             "wall-clock seconds — keeps the gate cheap")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.name}: {rule.description}")
        return 0
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.name for r in rules}
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.name in wanted]

    root = (args.root or _default_root()).resolve()
    baseline_path = args.baseline
    if baseline_path is None:
        candidate = root / BASELINE
        baseline_path = candidate if candidate.exists() else None
    baseline = load_baseline(baseline_path) if baseline_path else {}

    files = []
    for p in args.paths or [root / PACKAGE]:
        p = Path(p).resolve()
        files.extend(p.rglob("*.py") if p.is_dir() else [p])

    t0 = time.perf_counter()
    report = run_analysis(root, rules=rules, files=files, baseline=baseline,
                          root_label=PACKAGE)
    elapsed = time.perf_counter() - t0

    if args.json:
        args.json.write_text(report.to_json())

    for f, _key in report.findings:
        loc = f"{root / f.path}:{f.line}:{f.col}"
        sym = f" [in {f.symbol}]" if f.symbol else ""
        print(f"{loc}: {f.rule}: {f.message}{sym}")
    for key in report.stale_baseline:
        print(f"stale baseline entry (finding no longer exists — remove "
              f"it): {key}")
    c = report.to_dict()["counts"]
    print(f"replint: {report.files_scanned} files, "
          f"{c['findings']} finding(s), {c['baselined']} baselined, "
          f"{c['suppressed']} pragma-suppressed, "
          f"{c['stale_baseline']} stale baseline entr(ies) "
          f"[{elapsed:.2f}s]")

    if args.budget_s is not None and elapsed > args.budget_s:
        print(f"replint: wall-clock budget exceeded: {elapsed:.2f}s > "
              f"{args.budget_s:.2f}s", file=sys.stderr)
        return 2
    if args.gate and not report.gate_ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
