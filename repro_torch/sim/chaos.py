"""Chaos scenarios: streaming serving under seeded device churn.

``run_chaos`` wires the three open-ended pieces together — a
:class:`~repro.serving.stream.StreamingEngine`, a :func:`~repro.sim.openended.firehose`
arrival stream and a :class:`~repro.sim.churn.ChurnInjector` — and
reports recovery health on top of the usual streaming report:

* ``unresolved`` — the engine's safety valve; **must** be zero (every
  orphaned task terminates ALLOCATED-elsewhere or FAILED, never
  stranded — the accounting partition is asserted by
  ``tests/test_accounting_invariants.py``).
* ``recovery_ratio`` — orphans re-placed / orphans created.
* ``hp_completion_pct`` — HP completion under churn (the paper's
  headline metric must survive device loss, not just load).

Everything is seeded: the same :class:`ChaosConfig` replays the same
arrivals *and* the same failures, and a config with churn disabled runs
the engine bit-identically to a plain firehose run (pinned by the
zero-churn differential test).

CLI (the CI chaos-smoke step)::

    python -m repro.sim.chaos --scenario smoke --gate --json chaos.json
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, replace
from typing import Any, Optional

from .churn import ChurnConfig, ChurnInjector

# NOTE: ``serving.stream`` is imported inside :func:`run_chaos`, not here —
# the same sim/__init__ circularity ``sim/openended.py`` documents.


@dataclass(frozen=True)
class ChaosConfig:
    """One chaos scenario: offered load + churn schedule + gate floors."""

    name: str = "chaos"
    n_devices: int = 64
    policy: str = "scheduler"
    rate: float = 100.0             # firehose arrivals / s (network-wide)
    lp_fraction: float = 0.4
    duration: float = 20.0          # arrival horizon (virtual s)
    window: float = 0.25
    queue_capacity: int = 4096
    shed: str = "reject_newest"
    seed: int = 0
    # churn knobs (fractions of the fleet lost over ``duration``)
    fail_frac: float = 0.1          # expected hard-failed fraction
    drain_frac: float = 0.0         # expected drained fraction
    rejoin: bool = True
    rejoin_delay: float = 1.0
    link_rate: float = 0.0
    link_duration: float = 0.05
    max_down_frac: float = 0.5
    # gate floors (``chaos_gate``)
    min_recovery_ratio: float = 0.5
    min_hp_completion_pct: float = 95.0

    def churn_config(self) -> ChurnConfig:
        """Derive the churn schedule: rates sized so the expected event
        count is ``frac * n_devices`` over the arrival horizon, with
        churn confined to the middle 80% of the run (work exists to
        orphan, and the tail leaves room to recover)."""
        start = 0.1 * self.duration
        span = 0.8 * self.duration
        return ChurnConfig(
            name=self.name,
            n_devices=self.n_devices,
            fail_rate=self.fail_frac * self.n_devices / span,
            drain_rate=self.drain_frac * self.n_devices / span,
            rejoin=self.rejoin,
            rejoin_delay=self.rejoin_delay,
            link_rate=self.link_rate,
            link_duration=self.link_duration,
            start=start,
            duration=span,
            max_down_frac=self.max_down_frac,
            seed=self.seed,
        )


CHAOS_SCENARIOS: dict[str, ChaosConfig] = {
    # CI smoke: small fleet, heavy relative churn, seconds of wall-clock.
    # (The global recovery ratio includes inherently-unrecoverable orphans
    # — HP is source-local, so an HP orphan of a hard-failed source can
    # never re-admit — hence floors well below 1.0.)
    "smoke": ChaosConfig(
        name="smoke", n_devices=32, rate=20.0, lp_fraction=0.25,
        duration=10.0, fail_frac=0.25, drain_frac=0.1, rejoin_delay=1.0,
        min_recovery_ratio=0.25, min_hp_completion_pct=90.0),
    # Medium fleet with drains and link degradation mixed in.
    "churn_mixed": ChaosConfig(
        name="churn_mixed", n_devices=64, rate=20.0, lp_fraction=0.2,
        duration=20.0, fail_frac=0.15, drain_frac=0.1, link_rate=1.0,
        min_recovery_ratio=0.25, min_hp_completion_pct=90.0),
    # The acceptance scenario: 256 devices, >=10% hard-failing mid-run,
    # HP completion must stay above the paper-level 95% floor.  Offered
    # load is sized for a 100% churn-free baseline (the shared offload
    # link saturates near rate ~160 at this fleet size) so the gate
    # measures churn tolerance, not load shedding.
    "churn_heavy": ChaosConfig(
        name="churn_heavy", n_devices=256, rate=80.0, lp_fraction=0.2,
        duration=20.0, fail_frac=0.12, drain_frac=0.05, rejoin_delay=1.0,
        min_recovery_ratio=0.4, min_hp_completion_pct=95.0),
    # No rejoin: failed capacity stays gone (stress; relaxed HP floor).
    "churn_no_rejoin": ChaosConfig(
        name="churn_no_rejoin", n_devices=64, rate=20.0, lp_fraction=0.2,
        duration=15.0, fail_frac=0.1, rejoin=False,
        min_recovery_ratio=0.2, min_hp_completion_pct=80.0),
}


def run_chaos(cfg: ChaosConfig,
              max_requests: Optional[int] = None) -> dict[str, Any]:
    """Run one chaos scenario end to end; returns the streaming report
    plus the recovery metrics the gate reads."""
    from ..serving.stream import StreamingEngine   # lazy: see module note
    from .openended import FirehoseConfig, firehose

    engine = StreamingEngine(
        cfg.n_devices, policy=cfg.policy, window=cfg.window,
        queue_capacity=cfg.queue_capacity, shed=cfg.shed)
    fire = FirehoseConfig(
        name=cfg.name, n_devices=cfg.n_devices, rate=cfg.rate,
        lp_fraction=cfg.lp_fraction, seed=cfg.seed)
    injector = ChurnInjector(cfg.churn_config())
    report = engine.run(
        firehose(fire), until=cfg.duration, max_requests=max_requests,
        churn=iter(injector) if injector.enabled else None)
    m = report["metrics"]
    seen = m.get("orphans_created", 0)
    recovered = m.get("orphans_recovered", 0)
    return {
        "scenario": cfg.name,
        "policy": cfg.policy,
        "n_devices": cfg.n_devices,
        "churn_events": injector.counts(),
        "devices_failed": m.get("device_failures", 0),
        "devices_drained": m.get("device_drains", 0),
        "devices_rejoined": m.get("device_rejoins", 0),
        "orphans_created": seen,
        "orphans_recovered": recovered,
        "recovery_ratio": (recovered / seen) if seen else 1.0,
        "hp_completion_pct": m.get("hp_completion_pct", 0.0),
        "unresolved": report["unresolved"],
        "report": report,
    }


def chaos_gate(result: dict[str, Any], cfg: ChaosConfig) -> list[str]:
    """Return the list of gate violations (empty = pass)."""
    failures: list[str] = []
    if result["unresolved"] != 0:
        failures.append(
            f"unresolved={result['unresolved']} (must be 0: an orphan was "
            "stranded without a terminal state)")
    if result["devices_failed"] == 0 and cfg.fail_frac > 0.0:
        failures.append("no device failures fired (churn schedule empty?)")
    if result["recovery_ratio"] < cfg.min_recovery_ratio:
        failures.append(
            f"recovery_ratio={result['recovery_ratio']:.3f} < "
            f"floor {cfg.min_recovery_ratio}")
    if result["hp_completion_pct"] < cfg.min_hp_completion_pct:
        failures.append(
            f"hp_completion_pct={result['hp_completion_pct']:.2f} < "
            f"floor {cfg.min_hp_completion_pct}")
    return failures


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Run a chaos scenario (streaming engine under churn)")
    ap.add_argument("--scenario", default="smoke",
                    choices=sorted(CHAOS_SCENARIOS))
    ap.add_argument("--policy", default=None,
                    help="override the scenario's scheduling policy")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 unless every recovery floor holds")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the result dict as JSON")
    args = ap.parse_args(argv)

    cfg = CHAOS_SCENARIOS[args.scenario]
    if args.policy is not None:
        cfg = replace(cfg, policy=args.policy)
    if args.seed is not None:
        cfg = replace(cfg, seed=args.seed)
    result = run_chaos(cfg)
    print(f"[chaos] {cfg.name}: policy={cfg.policy} "
          f"devices={cfg.n_devices} failed={result['devices_failed']} "
          f"drained={result['devices_drained']} "
          f"rejoined={result['devices_rejoined']} "
          f"orphans={result['orphans_created']} "
          f"recovered={result['orphans_recovered']} "
          f"(ratio {result['recovery_ratio']:.3f}) "
          f"hp={result['hp_completion_pct']:.2f}% "
          f"unresolved={result['unresolved']}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=2, sort_keys=True)
        print(f"[chaos] wrote {args.json}")
    if args.gate:
        failures = chaos_gate(result, cfg)
        for f in failures:
            print(f"[chaos] GATE FAIL: {f}", file=sys.stderr)
        if failures:
            return 1
        print("[chaos] gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
