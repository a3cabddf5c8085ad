"""Degrade storms: streaming serving under saturating LP overload with the
variant ladder (DESIGN.md §17).

``run_storm`` runs the SAME seeded firehose twice through the streaming
engine over a ladder workload:

* **reject-only** — the pre-ladder baseline: ``reject_newest`` shedding,
  no degrade-before-reject, no degrade-instead-of-evict.
* **degrade** — the full ladder stack: the ``degrade`` shed policy walks
  queued LP requests down the ladder at the soft watermark, the scheduler
  retries infeasible LP admissions down the ladder before rejecting, and
  the ``degrade_shrink`` victim policy shrinks conflict victims in place
  before falling back to eviction.

The gate pins the ladder's value proposition — under overload, trading
accuracy beats dropping work:

* ``awg`` (accuracy-weighted goodput, % of the full-accuracy maximum)
  must be STRICTLY higher with the ladder than without, by at least
  ``min_awg_gain_pct`` points;
* HP completion must be equal or better with the ladder
  (``hp_slack_pct`` tolerates only float-level noise, default 0.0);
* the ladder must actually fire (``lp_degraded > 0``) — a storm too mild
  to degrade anything gates nothing.

Both runs are seeded and deterministic: the gate compares two exact
replays, not noisy samples.

CLI (the CI degrade-storm smoke step)::

    python -m repro.sim.degrade_storm --scenario smoke --gate \\
        --json degrade_storm.json

``--sweep`` replays the scenario across a rate ladder and prints the
accuracy-vs-completion frontier (EXPERIMENTS.md §Variant ladder).
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, replace
from typing import Any, Optional

# NOTE: ``serving.stream`` is imported inside :func:`_run_mode`, not here —
# the same sim/__init__ circularity ``sim/openended.py`` documents.


@dataclass(frozen=True)
class StormConfig:
    """One degrade storm: offered overload + ladder knobs + gate floors."""

    name: str = "degrade_storm"
    n_devices: int = 8
    rate: float = 40.0              # firehose arrivals / s (network-wide)
    lp_fraction: float = 0.9        # storms are LP-heavy by construction
    duration: float = 10.0          # arrival horizon (virtual s)
    window: float = 0.25
    queue_capacity: int = 4096      # sized so the queue never sheds HP:
    #                                 saturation must come from the
    #                                 scheduler, which is what the ladder
    #                                 negotiates with
    seed: int = 0
    workload: str = "paper_ladder"
    victim_policy: str = "degrade_shrink"
    max_requests: Optional[int] = 2000
    # gate floors (``storm_gate``)
    min_awg_gain_pct: float = 1.0   # ladder awg - reject awg, strict floor
    hp_slack_pct: float = 0.0       # tolerated HP drop (0 = equal-or-better)


STORM_SCENARIOS: dict[str, StormConfig] = {
    # CI smoke: small fleet, 10x LP overload, seconds of wall-clock.
    "smoke": StormConfig(
        name="smoke", n_devices=4, rate=40.0, duration=6.0,
        max_requests=400, min_awg_gain_pct=1.0),
    # The acceptance storm: sustained saturating overload on a mid fleet.
    "storm": StormConfig(
        name="storm", n_devices=8, rate=80.0, duration=10.0,
        max_requests=2000, min_awg_gain_pct=1.0),
    # Preemption-heavy mix: enough HP traffic that degrade-instead-of-
    # evict sees conflict victims to shrink.
    "shrink_storm": StormConfig(
        name="shrink_storm", n_devices=8, rate=60.0, lp_fraction=0.6,
        duration=10.0, max_requests=2000, min_awg_gain_pct=0.5),
}


def _run_mode(cfg: StormConfig, degrade: bool) -> dict[str, Any]:
    """One engine run; absolute outcome numbers for one mode."""
    from ..serving.stream import StreamingEngine   # lazy: see module note
    from .openended import FirehoseConfig, firehose

    engine = StreamingEngine(
        cfg.n_devices, workload=cfg.workload, window=cfg.window,
        queue_capacity=cfg.queue_capacity,
        shed="degrade" if degrade else "reject_newest",
        policy_kwargs={"degrade": degrade,
                       "victim_policy": (cfg.victim_policy if degrade
                                         else "farthest_deadline")})
    fire = FirehoseConfig(
        name=cfg.name, n_devices=cfg.n_devices, rate=cfg.rate,
        lp_fraction=cfg.lp_fraction, seed=cfg.seed)
    report = engine.run(firehose(fire), until=cfg.duration,
                        max_requests=cfg.max_requests)
    m = engine.metrics
    # Accuracy-weighted goodput, % of the full-accuracy maximum.  Computed
    # from the raw accumulator (not the summary) so the reject-only run —
    # whose summary rightly omits the ladder block — reports it too.
    awg = (100.0 * m.lp_accuracy_completed / m.lp_generated
           if m.lp_generated else 0.0)
    s = report["metrics"]
    return {
        "mode": "degrade" if degrade else "reject_only",
        "hp_completion_pct": s.get("hp_completion_pct", 0.0),
        "lp_completion_pct": s.get("lp_completion_pct", 0.0),
        "awg_pct": round(awg, 3),
        "lp_generated": m.lp_generated,
        "lp_shed": m.lp_shed,
        "lp_failed_alloc": m.lp_failed_alloc,
        "lp_degraded": m.lp_degraded,
        "degrade_shrinks": m.degrade_shrinks,
        "variant_admissions": {str(v): n for v, n in
                               sorted(m.variant_admissions.items())},
        "unresolved": report["unresolved"],
    }


def run_storm(cfg: StormConfig) -> dict[str, Any]:
    """Both modes on the identical arrival replay, plus the gate deltas."""
    reject = _run_mode(cfg, degrade=False)
    degrade = _run_mode(cfg, degrade=True)
    return {
        "scenario": cfg.name,
        "n_devices": cfg.n_devices,
        "rate": cfg.rate,
        "workload": cfg.workload,
        "reject_only": reject,
        "degrade": degrade,
        "awg_gain_pct": round(degrade["awg_pct"] - reject["awg_pct"], 3),
        "hp_delta_pct": round(degrade["hp_completion_pct"]
                              - reject["hp_completion_pct"], 3),
    }


def storm_gate(result: dict[str, Any], cfg: StormConfig) -> list[str]:
    """Return the list of gate violations (empty = pass)."""
    failures: list[str] = []
    for mode in ("reject_only", "degrade"):
        if result[mode]["unresolved"] != 0:
            failures.append(
                f"{mode}: unresolved={result[mode]['unresolved']} "
                "(must be 0)")
    if result["degrade"]["lp_degraded"] == 0:
        failures.append(
            "ladder never fired (lp_degraded=0) — the storm is too mild "
            "to gate anything")
    if result["awg_gain_pct"] < cfg.min_awg_gain_pct:
        failures.append(
            f"awg_gain_pct={result['awg_gain_pct']:.3f} < "
            f"floor {cfg.min_awg_gain_pct} (degrade must STRICTLY beat "
            "reject-only on accuracy-weighted goodput)")
    if result["hp_delta_pct"] < -cfg.hp_slack_pct:
        failures.append(
            f"hp_delta_pct={result['hp_delta_pct']:.3f} < "
            f"-{cfg.hp_slack_pct} (degrade must keep HP completion "
            "equal-or-better)")
    return failures


def sweep(cfg: StormConfig, rates: list[float]) -> list[dict[str, Any]]:
    """The accuracy-vs-completion frontier: one storm per offered rate."""
    rows = []
    for rate in rates:
        r = run_storm(replace(cfg, name=f"{cfg.name}_r{rate:g}", rate=rate))
        rows.append({
            "rate": rate,
            "reject_lp_pct": r["reject_only"]["lp_completion_pct"],
            "reject_awg_pct": r["reject_only"]["awg_pct"],
            "degrade_lp_pct": r["degrade"]["lp_completion_pct"],
            "degrade_awg_pct": r["degrade"]["awg_pct"],
            "awg_gain_pct": r["awg_gain_pct"],
            "hp_delta_pct": r["hp_delta_pct"],
        })
    return rows


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Run a degrade storm (variant ladder vs reject-only)")
    ap.add_argument("--scenario", default="smoke",
                    choices=sorted(STORM_SCENARIOS))
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 unless the ladder strictly beats "
                         "reject-only (see storm_gate)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the result dict as JSON")
    ap.add_argument("--sweep", default=None, metavar="RATES",
                    help="comma-separated offered rates: print the "
                         "accuracy-vs-completion frontier instead")
    args = ap.parse_args(argv)

    cfg = STORM_SCENARIOS[args.scenario]
    if args.seed is not None:
        cfg = replace(cfg, seed=args.seed)

    if args.sweep:
        rows = sweep(cfg, [float(r) for r in args.sweep.split(",")])
        head = (f"{'rate':>8}{'reject lp%':>12}{'reject awg%':>13}"
                f"{'degrade lp%':>13}{'degrade awg%':>14}"
                f"{'awg gain':>10}{'hp delta':>10}")
        print(head)
        print("-" * len(head))
        for row in rows:
            print(f"{row['rate']:>8g}{row['reject_lp_pct']:>12.2f}"
                  f"{row['reject_awg_pct']:>13.2f}"
                  f"{row['degrade_lp_pct']:>13.2f}"
                  f"{row['degrade_awg_pct']:>14.2f}"
                  f"{row['awg_gain_pct']:>10.2f}"
                  f"{row['hp_delta_pct']:>10.2f}")
        if args.json:
            with open(args.json, "w") as fh:
                json.dump(rows, fh, indent=2, sort_keys=True)
            print(f"[storm] wrote {args.json}")
        return 0

    result = run_storm(cfg)
    print(f"[storm] {cfg.name}: devices={cfg.n_devices} rate={cfg.rate:g} "
          f"workload={cfg.workload}")
    for mode in ("reject_only", "degrade"):
        r = result[mode]
        print(f"[storm]   {mode:<12} hp={r['hp_completion_pct']:.2f}% "
              f"lp={r['lp_completion_pct']:.2f}% awg={r['awg_pct']:.2f}% "
              f"shed={r['lp_shed']} rejected={r['lp_failed_alloc']} "
              f"degraded={r['lp_degraded']} shrinks={r['degrade_shrinks']}")
    print(f"[storm]   awg_gain={result['awg_gain_pct']:+.3f}pp "
          f"hp_delta={result['hp_delta_pct']:+.3f}pp")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=2, sort_keys=True)
        print(f"[storm] wrote {args.json}")
    if args.gate:
        failures = storm_gate(result, cfg)
        for f in failures:
            print(f"[storm] GATE FAIL: {f}", file=sys.stderr)
        if failures:
            return 1
        print("[storm] gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
