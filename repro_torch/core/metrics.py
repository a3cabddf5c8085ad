"""Experiment counters — one field-group per paper figure/table."""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from statistics import mean
from typing import Any


def _mean_ms(xs) -> float:
    """Mean in milliseconds of a latency series — a plain list or any sink
    exposing an exact ``mean()`` (telemetry.BoundedSeries on the streaming
    path, whose iteration covers only its recent window)."""
    if not xs:
        return 0.0
    m = xs.mean() if hasattr(xs, "mean") else mean(xs)
    return m * 1e3


@dataclass
class Metrics:
    scenario: str = ""

    # Fig 2 — frame completion
    frames_total: int = 0
    frames_completed: int = 0

    # Fig 3 — high-priority completion (split by whether preemption was used)
    hp_generated: int = 0
    hp_completed: int = 0
    hp_completed_via_preemption: int = 0
    hp_failed_alloc: int = 0
    hp_failed_runtime: int = 0

    # Fig 4/5/6, Table 2 — low-priority completion
    lp_generated: int = 0
    lp_allocated: int = 0
    lp_completed: int = 0
    lp_failed_alloc: int = 0
    lp_failed_runtime: int = 0
    lp_offloaded: int = 0
    lp_offloaded_completed: int = 0
    lp_requests_total: int = 0
    lp_requests_completed: int = 0
    lp_request_fractions: list[float] = field(default_factory=list)

    # Streaming path (serving/stream.py) — load shedding at the admission
    # queue.  A shed request's tasks never reach the scheduler: they are
    # their own terminal bucket, partitioning the generated set together
    # with the completed/failed counters (tests/test_accounting_invariants).
    # Always zero on the closed-workload paths, where the summary keys are
    # omitted so legacy summaries (and the golden replays) stay byte-equal.
    hp_shed: int = 0
    lp_shed: int = 0
    lp_degraded: int = 0

    # Variant ladder (DESIGN.md §17) — accuracy-aware degradation.
    # ``variant_admissions`` histograms LP allocations by the ladder rung
    # they were admitted at (rung > 0 only; a legacy one-bit degrade on a
    # ladder-free profile counts under rung 1).  ``lp_accuracy_completed``
    # accumulates the admitted rung's benchmark accuracy over completed LP
    # tasks — the numerator of accuracy-weighted goodput.  The accumulator
    # runs unconditionally (deterministic, same order as lp_completed), but
    # the summary keys appear only when some task ran degraded, so
    # ladder-free summaries stay byte-identical.
    variant_admissions: Counter = field(default_factory=Counter)
    lp_accuracy_completed: float = 0.0
    degrade_shrinks: int = 0        # degrade-instead-of-evict shrink count

    # Churn plane (DESIGN.md §16) — device lifecycle events and orphan
    # recovery.  Orphans are NOT a new terminal bucket: a recovered orphan
    # counts realloc_success (then completes or fails at runtime like any
    # allocation), an unrecoverable LP orphan counts realloc_failure, and a
    # non-re-admittable HP orphan counts hp_failed_alloc — the existing
    # partition absorbs all of them.  These counters are observability
    # only; always zero (and omitted from summaries) without churn.
    device_failures: int = 0
    device_drains: int = 0
    device_rejoins: int = 0
    orphans_created: int = 0
    orphans_recovered: int = 0

    # Fig 7, Table 3 — preemption
    preemptions: int = 0
    preempted_by_cores: Counter = field(default_factory=Counter)
    realloc_success: int = 0
    realloc_failure: int = 0

    # Fig 8 — core allocation of LP tasks
    core_alloc_local: Counter = field(default_factory=Counter)
    core_alloc_offloaded: Counter = field(default_factory=Counter)

    # Fig 9/10 — scheduler wall-clock times (seconds)
    t_hp_initial: list[float] = field(default_factory=list)
    t_hp_preempt: list[float] = field(default_factory=list)
    t_lp_alloc: list[float] = field(default_factory=list)
    t_realloc: list[float] = field(default_factory=list)
    # eviction-loop phase of preempting HP admissions only (DESIGN.md §12;
    # the quantity bench_preemption's vectorized-vs-scalar gate compares)
    t_evict: list[float] = field(default_factory=list)

    # Heterogeneous workloads (core/profiles.py): outcome counters per task
    # type.  Un-annotated tasks (task_type=None — the paper's single-model
    # world) record nothing here, so legacy summaries stay byte-identical.
    task_type_counts: dict[str, Counter] = field(default_factory=dict)

    def count_type(self, task_type, key: str, n: int = 1) -> None:
        """Bump a per-task-type outcome counter (no-op for untyped tasks)."""
        if task_type is None:
            return
        self.task_type_counts.setdefault(task_type, Counter())[key] += n

    def pct(self, num: int, den: int) -> float:
        return 100.0 * num / den if den else 0.0

    def summary(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "scenario": self.scenario,
            "frames_total": self.frames_total,
            "frame_completion_pct": round(
                self.pct(self.frames_completed, self.frames_total), 2
            ),
            "hp_generated": self.hp_generated,
            # Raw terminal-outcome counts: together with the ``realloc_*``
            # pair below they partition the generated task set (asserted
            # per scenario x policy by tests/test_accounting_invariants.py).
            "hp_completed": self.hp_completed,
            "hp_failed_alloc": self.hp_failed_alloc,
            "hp_failed_runtime": self.hp_failed_runtime,
            "lp_completed": self.lp_completed,
            "lp_failed_alloc": self.lp_failed_alloc,
            "lp_failed_runtime": self.lp_failed_runtime,
            "hp_completion_pct": round(self.pct(self.hp_completed, self.hp_generated), 2),
            "hp_via_preemption_pct": round(
                self.pct(self.hp_completed_via_preemption, self.hp_generated), 2
            ),
            "lp_generated": self.lp_generated,
            "lp_completion_pct": round(self.pct(self.lp_completed, self.lp_generated), 2),
            "lp_offloaded": self.lp_offloaded,
            "lp_offloaded_completion_pct": round(
                self.pct(self.lp_offloaded_completed, self.lp_offloaded), 2
            ),
            "lp_per_request_completion_pct": round(
                100.0 * mean(self.lp_request_fractions), 2
            )
            if self.lp_request_fractions
            else 0.0,
            "lp_set_completion_pct": round(
                self.pct(self.lp_requests_completed, self.lp_requests_total), 2
            ),
            "preemptions": self.preemptions,
            "preempted_2core": self.preempted_by_cores.get(2, 0),
            "preempted_4core": self.preempted_by_cores.get(4, 0),
            "realloc_success": self.realloc_success,
            "realloc_failure": self.realloc_failure,
            "core2_local": self.core_alloc_local.get(2, 0),
            "core4_local": self.core_alloc_local.get(4, 0),
            "core2_offloaded": self.core_alloc_offloaded.get(2, 0),
            "core4_offloaded": self.core_alloc_offloaded.get(4, 0),
            "t_hp_initial_ms": round(_mean_ms(self.t_hp_initial), 3),
            "t_hp_preempt_ms": round(_mean_ms(self.t_hp_preempt), 3),
            "t_lp_alloc_ms": round(_mean_ms(self.t_lp_alloc), 3),
            "t_realloc_ms": round(_mean_ms(self.t_realloc), 3),
        }
        if self.hp_shed or self.lp_shed or self.lp_degraded:
            # Present only on the streaming path: closed-workload summaries
            # keep their historic key set (golden replays compare exact
            # dict equality).
            out["hp_shed"] = self.hp_shed
            out["lp_shed"] = self.lp_shed
            out["lp_degraded"] = self.lp_degraded
        if self.variant_admissions or self.degrade_shrinks:
            # Present only when the variant ladder actually fired (a task
            # was admitted below rung 0 or shrunk in place): ladder-free
            # runs — every committed golden — keep their historic key set.
            out["variant_admissions"] = {
                str(v): n for v, n in sorted(self.variant_admissions.items())
            }
            out["degrade_shrinks"] = self.degrade_shrinks
            out["accuracy_goodput_pct"] = round(
                100.0 * self.lp_accuracy_completed / self.lp_generated, 2
            ) if self.lp_generated else 0.0
        if (self.device_failures or self.device_drains
                or self.device_rejoins or self.orphans_created):
            # Present only under churn: the closed-workload golden replays
            # (and every churn-free run) keep their historic key set.
            out["device_failures"] = self.device_failures
            out["device_drains"] = self.device_drains
            out["device_rejoins"] = self.device_rejoins
            out["orphans_created"] = self.orphans_created
            out["orphans_recovered"] = self.orphans_recovered
        if self.task_type_counts:
            # Present only for heterogeneous workloads: single-model (paper)
            # summaries keep their historic key set, which the golden-replay
            # suite compares with exact dict equality.
            out["task_types"] = {
                t: dict(sorted(c.items()))
                for t, c in sorted(self.task_type_counts.items())
            }
        return out
