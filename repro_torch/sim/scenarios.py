"""Large-N scenario suite: scaling the paper's workload beyond 4 devices.

The paper's evaluation (§5/§6) stops at four RPi2B devices and 1296 frames.
The ROADMAP north-star is a production-scale serving system, so this module
generates parameterised workloads for **4 -> 256+ devices** and drives the
scheduler end-to-end over them (admission -> time-slotted occupancy ->
expiry), measuring the controller's *wall-clock admission latency* — the
quantity the O(log n) calendar rewrite (DESIGN.md §2) is meant to keep off
the critical path.

Three arrival families (DESIGN.md §5.2):

* ``poisson``     — independent per-device Poisson HP arrivals; a fraction
                    of HP tasks spawns an LP set (the steady-state regime).
* ``bursty``      — on/off modulated Poisson: burst phases at ``burst_factor``
                    times the base rate separated by near-idle phases
                    (arrival correlation stresses the batch-admission path).
* ``adversarial`` — synchronised waves: every device emits an HP task at the
                    same instant, immediately followed by the wave's LP sets;
                    maximises link contention and preemption pressure
                    (worst case for a shared single-AP network, paper §3).
* ``preempt_storm`` — the preemption-adversarial family (DESIGN.md §12):
                    a saturation phase packs every device with max-size LP
                    sets, then synchronised HP-only bursts aim at the loaded
                    devices every ``wave_period`` — each burst admission has
                    to walk the eviction/reallocation path, which is what
                    ``bench_preemption`` (benchmarks/scheduler_micro.py)
                    measures across the 4 -> 1024 tier ladder.

HP:LP mix sweeps ride on ``lp_fraction`` (the probability that an HP arrival
spawns an LP set); ``sweep_mix`` builds the standard ratio ladder.

The driver deliberately runs at the *admission* level rather than through
``sim.experiment.Runtime``: execution noise and completion bookkeeping are
orthogonal to scheduler scalability, and at 256 devices the discrete-event
runtime would dominate the measurement we care about.  The scheduler still
sees a fully live network state — allocations occupy the calendars until
their slots expire, exactly as in the full simulation.
"""
from __future__ import annotations

import heapq
import time as _time
from dataclasses import dataclass, replace
from typing import Iterable, Optional, Sequence

import numpy as np

from ..core.calendar import NetworkState
from ..core.metrics import Metrics
from ..core.network import NetworkConfig, resolve_network
from ..core.profiles import PAPER_TYPE, get_workload, validate_workload_name
from ..core.scheduler import PreemptionAwareScheduler
from ..core.task import LowPriorityRequest, Priority, Task, reset_id_counters

ARRIVAL_KINDS = ("poisson", "bursty", "adversarial", "preempt_storm")

#: The standard device-count ladder.  The 1024 tier exists to exercise the
#: vectorized probe plane (calendar.py) well past the paper's four devices —
#: admission latency there is dominated by stacked NumPy passes, not by
#: per-device Python loops, so the controller keeps up with a four-digit
#: fleet (benchmarks/scheduler_micro.py reports the measured latencies).
LARGE_N_TIERS = (4, 16, 64, 256, 1024)


@dataclass(frozen=True)
class Arrival:
    """One scheduling trigger: an HP task, optionally spawning an LP set."""

    t: float
    device: int
    n_lp_tasks: int          # 0 = HP only; >0 = HP followed by an LP set
    task_type: Optional[str] = None    # workload-profile key (mixed fleets)


@dataclass(frozen=True)
class LargeNConfig:
    """A parameterised large-network workload.

    ``hp_rate`` is per-device HP arrivals per second; with the RPi2B timing
    model one HP task occupies one core for ~1 s, and each LP task occupies
    2 cores for ~17 s, so utilisation scales roughly as
    ``hp_rate * (1 + lp_fraction * E[set size] * 34 / capacity)``.
    """

    name: str
    n_devices: int = 64                      # 4 .. 256+
    duration: float = 300.0                  # seconds of arrivals
    arrival: str = "poisson"                 # poisson | bursty | adversarial
    hp_rate: float = 0.05                    # HP arrivals / device / second
    lp_fraction: float = 0.6                 # P(HP arrival spawns an LP set)
    lp_set_sizes: tuple[int, ...] = (1, 2, 3, 4)
    lp_deadline: float = 120.0               # LP deadline relative to arrival
    lp_delay: float = 1.1                    # stage-2 latency before LP request
    burst_factor: float = 6.0                # bursty: peak/base rate ratio
    burst_len: float = 10.0                  # bursty: burst phase length (s)
    idle_len: float = 30.0                   # bursty: idle phase length (s)
    wave_period: float = 8.0                 # adversarial: seconds between waves
    seed: int = 0
    # Workload spec name (core/profiles.py): "paper" = the single-model
    # seed workload; "mixed_edge" interleaves three model profiles with
    # their own benchmark tables, transfer sizes and LP deadlines.
    workload: str = PAPER_TYPE

    def __post_init__(self) -> None:
        if self.arrival not in ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival family: {self.arrival}")
        validate_workload_name(self.workload)


def sweep_devices(
    base: LargeNConfig, sizes: Sequence[int] = LARGE_N_TIERS
) -> list[LargeNConfig]:
    """Device-count ladder with per-size names (4 -> 1024 by default)."""
    return [replace(base, name=f"{base.name}_n{n}", n_devices=n) for n in sizes]


def sweep_mix(
    base: LargeNConfig, fractions: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0)
) -> list[LargeNConfig]:
    """HP:LP ratio ladder (lp_fraction = share of HP arrivals spawning sets)."""
    return [
        replace(base, name=f"{base.name}_mix{int(f * 100)}", lp_fraction=f)
        for f in fractions
    ]


def generate_arrivals(cfg: LargeNConfig) -> list[Arrival]:
    """Deterministic (seeded) arrival stream, sorted by time."""
    rng = np.random.default_rng(cfg.seed * 9973 + cfg.n_devices)
    pick_type = _type_picker(cfg)
    out: list[Arrival] = []
    if cfg.arrival == "adversarial":
        n_waves = max(1, int(cfg.duration / cfg.wave_period))
        for w in range(n_waves):
            t = w * cfg.wave_period
            for d in range(cfg.n_devices):
                out.append(Arrival(t, d, _lp_size(cfg, rng), pick_type()))
        return out

    if cfg.arrival == "preempt_storm":
        # Saturation phase: every device receives a jittered train of
        # max-size LP sets inside the first wave period, filling its
        # calendar.  Burst phases: synchronised HP-only arrivals at EVERY
        # device — aimed exactly at the saturated calendars, so each one
        # exercises eviction + victim reallocation.
        sat_end = min(cfg.wave_period, cfg.duration)
        for d in range(cfg.n_devices):
            t = float(rng.uniform(0.0, 0.5 * sat_end))
            while t < sat_end:
                out.append(Arrival(t, d, max(cfg.lp_set_sizes), pick_type()))
                t += float(rng.exponential(sat_end / 4.0))
        n_waves = max(1, int((cfg.duration - sat_end) / cfg.wave_period))
        for w in range(n_waves):
            t = sat_end + w * cfg.wave_period
            if t >= cfg.duration:   # every family stays inside [0, duration)
                break
            for d in range(cfg.n_devices):
                out.append(Arrival(t, d, 0, pick_type()))
        out.sort(key=lambda a: (a.t, a.device))
        return out

    for d in range(cfg.n_devices):
        t = 0.0
        while True:
            rate = cfg.hp_rate
            if cfg.arrival == "bursty":
                period = cfg.burst_len + cfg.idle_len
                in_burst = (t % period) < cfg.burst_len
                rate = cfg.hp_rate * (cfg.burst_factor if in_burst else 0.1)
            t += float(rng.exponential(1.0 / max(rate, 1e-9)))
            if t >= cfg.duration:
                break
            out.append(Arrival(t, d, _lp_size(cfg, rng), pick_type()))
    out.sort(key=lambda a: (a.t, a.device))
    return out


def _type_picker(cfg: LargeNConfig):
    """Per-arrival task-type draw for mixed workloads.  Single-profile
    specs return a constant None picker WITHOUT consuming randomness, so
    the paper-workload arrival streams are bit-identical to before; mixed
    specs draw from a dedicated rng (never the arrival-time rng)."""
    spec = get_workload(cfg.workload)
    if not spec.is_mixed:
        return lambda: None
    weights = spec.mix_weights()
    names = [t for t, _ in weights]
    p = np.asarray([w for _, w in weights])
    trng = np.random.default_rng(cfg.seed * 7907 + cfg.n_devices + 1)
    return lambda: str(names[int(trng.choice(len(names), p=p))])


def _lp_size(cfg: LargeNConfig, rng: np.random.Generator) -> int:
    if cfg.lp_fraction <= 0.0 or float(rng.random()) >= cfg.lp_fraction:
        return 0
    return int(rng.choice(cfg.lp_set_sizes))


def run_large_n(
    cfg: LargeNConfig,
    net: Optional[NetworkConfig] = None,
    *,
    batch_window: float = 0.0,
    preemption: bool = True,
    preemption_plane: bool = True,
    state: Optional[object] = None,
    churn: Optional[Iterable] = None,
) -> dict:
    """Drive the scheduler over the scenario's arrival stream, end to end.

    ``batch_window > 0`` buffers LP requests arriving within the window and
    admits each buffer through ``allocate_low_priority_batch`` (the
    controller-side batching mode); ``0`` admits per request like the paper.
    ``state`` lets benchmarks substitute ``ReferenceNetworkState`` so old and
    new calendars run the *same* workload; ``preemption_plane=False`` forces
    the scalar eviction loop (the preemption plane's differential
    reference — ``bench_preemption`` runs both over identical storms).
    ``churn`` is an optional time-sorted stream of
    :class:`~repro.sim.churn.ChurnEvent` records merged into the
    controller event heap (``None`` executes zero churn code, keeping
    churn-free runs bit-identical).

    Returns a summary dict with admission counts and wall-clock admission
    latency statistics (microseconds per call).
    """
    # An explicit net wins but must cover the workload's task types
    # (resolve_network raises early on a mismatch).
    net = resolve_network(net, cfg.workload)
    reset_id_counters()
    st = state if state is not None else NetworkState(cfg.n_devices)
    metrics = Metrics(cfg.name)
    sched = PreemptionAwareScheduler(st, net, preemption=preemption,
                                     metrics=metrics,
                                     preemption_plane=preemption_plane)
    arrivals = generate_arrivals(cfg)

    hp_ok = hp_fail = lp_ok = lp_fail = 0
    buffer: list[LowPriorityRequest] = []

    def tally_lp(results) -> None:
        nonlocal lp_ok, lp_fail
        for res in results:
            lp_ok += len(res.allocations)
            lp_fail += len(res.failed)

    # Chronological controller event stream (the calendars require monotone
    # `now`): HP admission at arrival time; the LP request materialises
    # ``lp_delay`` later (stage-2 latency); in batching mode a flush event
    # closes ``batch_window`` after the first buffered request.
    HP, LP, FLUSH, CHURN = 0, 1, 2, 3
    seq = 0
    heap: list[tuple[float, int, int, object]] = []
    for a in arrivals:
        heap.append((a.t, seq, HP, a))
        seq += 1
    if churn is not None:
        for ev in churn:
            heap.append((ev.t, seq, CHURN, ev))
            seq += 1
    heapq.heapify(heap)
    flush_pending = False

    t_wall = _time.perf_counter()
    while heap:
        now, _, kind, payload = heapq.heappop(heap)
        if kind == HP:
            a = payload
            hp = Task(priority=Priority.HIGH, source_device=a.device,
                      deadline=net.hp_deadline(now, a.task_type), frame_id=0,
                      task_type=a.task_type, created_at=now)
            if sched.allocate_high_priority(hp, now).success:
                hp_ok += 1
            else:
                hp_fail += 1
            if a.n_lp_tasks > 0:
                heapq.heappush(heap, (now + cfg.lp_delay, seq, LP, a))
                seq += 1
        elif kind == LP:
            a = payload
            # Per-type relative deadline when the profile declares one
            # (mixed fleets), else the scenario-wide lp_deadline.
            prof = net.profile(a.task_type)
            rel_dl = (prof.lp_deadline if prof.lp_deadline is not None
                      else cfg.lp_deadline)
            req = LowPriorityRequest(source_device=a.device,
                                     deadline=now + rel_dl,
                                     frame_id=0, n_tasks=a.n_lp_tasks,
                                     task_type=a.task_type,
                                     created_at=now)
            req.make_tasks()
            if batch_window > 0.0:
                buffer.append(req)
                if not flush_pending:
                    flush_pending = True
                    heapq.heappush(heap, (now + batch_window, seq, FLUSH, None))
                    seq += 1
            else:
                tally_lp([sched.allocate_low_priority(req, now)])
        elif kind == FLUSH:
            flush_pending = False
            if buffer:
                tally_lp(sched.allocate_low_priority_batch(buffer, now))
                buffer = []
        else:                                      # CHURN (DESIGN.md §16)
            ev = payload
            if ev.kind == "fail":
                orphans, _ = sched.fail_device(ev.device, now)
                sched.settle_hp_orphans(orphans, now)
            elif ev.kind == "drain":
                sched.drain_device(ev.device, now)
            elif ev.kind == "rejoin":
                sched.rejoin_device(ev.device, now)
            elif ev.kind == "link" and ev.duration > 0.0:
                st.link.reserve(now, now + ev.duration, ("churn", ev.device))
    wall = _time.perf_counter() - t_wall

    hp_lat = metrics.t_hp_initial + metrics.t_hp_preempt
    out = {
        "scenario": cfg.name,
        "arrival": cfg.arrival,
        "n_devices": cfg.n_devices,
        "n_arrivals": len(arrivals),
        "hp_admitted": hp_ok,
        "hp_failed": hp_fail,
        "lp_allocated": lp_ok,
        "lp_failed": lp_fail,
        "preemptions": metrics.preemptions,
        "realloc_success": metrics.realloc_success,
        "realloc_failure": metrics.realloc_failure,
        "hp_alloc_us_mean": _us_mean(hp_lat),
        "hp_alloc_us_p99": _us_pct(hp_lat, 99),
        # preemption-path admissions only (the quantity bench_preemption
        # compares between the vectorized plane and the scalar loop)
        "hp_preempt_us_mean": _us_mean(metrics.t_hp_preempt),
        "n_hp_preempt": len(metrics.t_hp_preempt),
        "lp_alloc_us_mean": _us_mean(metrics.t_lp_alloc),
        "lp_alloc_us_p99": _us_pct(metrics.t_lp_alloc, 99),
        "wall_s": wall,
    }
    if metrics.device_failures or metrics.device_drains \
            or metrics.device_rejoins:
        # churn runs only: churn-free summaries keep their historic key set
        out["device_failures"] = metrics.device_failures
        out["device_drains"] = metrics.device_drains
        out["device_rejoins"] = metrics.device_rejoins
        out["orphans_created"] = metrics.orphans_created
        out["orphans_recovered"] = metrics.orphans_recovered
    return out


def _us_mean(xs: list[float]) -> float:
    return 1e6 * sum(xs) / len(xs) if xs else 0.0


def _us_pct(xs: list[float], q: float) -> float:
    return 1e6 * float(np.percentile(xs, q)) if xs else 0.0
