"""Offline optimal-placement oracle: the scheduling-quality measuring stick.

PRs 4-5 gate *speed* (calendar/preemption-plane CI benchmarks); nothing
gated decision *quality* — a fast path that silently schedules worse would
pass every gate.  This module provides the missing reference: an exact
solver for the one-shot joint placement problem every slot-based policy
answers online (DESIGN.md §13).

The model
---------
An :class:`OracleInstance` freezes one admission question: a set of tasks
(released at decision time), the devices' existing skyline occupancy, and
the shared link's existing occupancy.  A *placement* assigns each task at
most one ``(device, cores, start)`` option subject to

* **deadline** — ``start + completion_duration(cores) <= deadline``;
* **device capacity** — chosen slots plus existing occupancy never exceed
  the core capacity on any device;
* **link occupancy** — an offloaded task's input transfer (one link-slot of
  ``net.slot(input_bytes)`` seconds) must fit on the shared unit-capacity
  link between release and the task's start.  The oracle relaxes the real
  policies' *contiguous* transfers to *preemptible* ones (classic EDF
  interval conditions), and charges no allocation/state-update messages.

Both relaxations only widen the feasible set, so the oracle's optimum is an
upper bound on what any registered slot-based policy can achieve on the
same instance — a policy "beating" it means the model is wrong (and a test
fails).  The objective is the lexicographic quality order the paper argues
for — HP completions, then total completions, then an accuracy-weighted
earliness ("goodput") tiebreak — encoded as a single weighted sum.

Start times are restricted to a finite *candidate grid*: existing calendar
breakpoints, task releases, link-backlog clearing points, closed under sums
of the instance's slot durations.  Any feasible schedule left-shifts onto
this grid without losing completions (each start anchors at a release, an
existing breakpoint, another chosen slot's end, or the point where the link
backlog clears), so the grid optimum equals the continuous optimum.

Backends
--------
* ``"milp"``  — ``scipy.optimize.milp`` (HiGHS) over binary option vars.
* ``"brute"`` — exhaustive depth-first branch-and-bound over the same
  option set; independent of any solver, it doubles as the correctness
  oracle for the MILP encoding (differential-tested in
  ``tests/test_oracle.py``).
* ``"cpsat"`` — ``ortools`` CP-SAT, behind a feature check (the container
  does not ship ortools; the backend raises a clear error when absent).
* ``"auto"``  — brute below a search-space threshold or at tiny job
  counts (where the suffix-max bound beats MILP even at thousands of
  option columns), else MILP (brute when scipy is unavailable).

:class:`OraclePolicy` (registered as ``"oracle"``) applies the instance
solver online, one decision at a time: HP admission via the closed-form
optimum (earliest feasible 1-core slot on the source device), each LP
request as one joint instance.  It is per-decision optimal, *not*
clairvoyant across future arrivals and it never preempts — see DESIGN.md
§13 for exactly what competitive ratios against it do and don't certify.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

import numpy as np

from .calendar import NetworkState
from .metrics import Metrics
from .network import NetworkConfig
from .policy import CalendarPolicy, Decision, DecisionStatus, register_policy
from .scheduler import Allocation
from .task import LowPriorityRequest, Priority, Task, TaskState

#: Feasibility slack for float comparisons (well below EPS and any slot).
FEAS = 1e-9
#: Link-interval rows compare *sums* of transfer durations against free
#: time measured between grid points rounded at ``_ROUND`` — accumulated
#: rounding error can exceed ``FEAS``, and HiGHS applies its own ~1e-7
#: primal tolerance anyway.  All backends must use the SAME slack on link
#: rows or the brute/MILP differential diverges on exactly-packed links.
LINK_TOL = 1e-7
#: Grid points are deduplicated at nanosecond resolution.
_ROUND = 9

#: Default instance-size guards (DESIGN.md §13 — "oracle-sized" means a
#: handful of tasks over a few devices; beyond these the instance raises).
MAX_GRID = 4000
#: Above this many option columns BOTH backends degrade (brute's bound
#: stops pruning enough; HiGHS crawls on near-degenerate binaries), so the
#: instance errors and the policy falls back to singletons.  Variant
#: ladders triple the columns per job, which is what pushed sustained-load
#: joint instances from "slow" to "minutes each" at the old 20k cap;
#: 6k keeps the worst measured joint solve under ~1 s at identical
#: measured quality on the ladder scenarios.
MAX_OPTIONS = 6_000
MAX_SUMS = 20_000

#: ``auto`` backend: brute-force below this assignment-space size.
_BRUTE_SPACE = 20_000
#: ``auto`` also prefers brute at or below this JOB count regardless of
#: option count: the branch-and-bound's suffix-max bound makes its cost
#: near-linear in options when the branching depth is tiny, while HiGHS
#: degrades badly on thousands of near-degenerate binary columns (variant
#: ladders triple the columns at nearly identical objective weights — a
#: 2-job/4k-option ladder instance measured 0.03 s brute vs >170 s MILP).
_BRUTE_JOBS = 3


def _have_scipy_milp() -> bool:
    try:
        from scipy.optimize import milp  # noqa: F401
        return True
    except ImportError:                                  # pragma: no cover
        return False


def have_ortools() -> bool:
    """Feature check for the optional CP-SAT backend (not in the image)."""
    try:
        from ortools.sat.python import cp_model  # noqa: F401
        return True
    except ImportError:
        return False


class OracleInstanceError(ValueError):
    """The instance exceeds the oracle's size guards (or cannot be built)."""


# ====================================================================== #
# Problem data                                                           #
# ====================================================================== #
@dataclass(frozen=True)
class JobRung:
    """One variant-ladder rung of an LP job (DESIGN.md §17): the same
    shape as the job's base fields, at the rung's benchmark stats."""

    accuracy: float
    durations: Mapping[int, float]
    completion_durations: Mapping[int, float]
    xfer: float


@dataclass(frozen=True)
class OracleJob:
    """One task of the one-shot placement instance."""

    idx: int
    is_hp: bool
    source_device: int
    release: float
    deadline: float
    #: cores -> reserved slot duration (what occupies the calendar)
    durations: Mapping[int, float]
    #: cores -> completion offset (HP completes at exec mean, before its
    #: padded slot ends; LP completion criterion is the padded slot itself,
    #: matching the admission rules the policies implement)
    completion_durations: Mapping[int, float]
    xfer: float                    # input-transfer link-slot duration
    offloadable: bool
    accuracy: float = 1.0
    #: Variant-ladder rungs below the base (variant 0 = the fields above).
    #: The oracle enumerates one option column per rung, so its optimum
    #: covers every admissible variant choice — what the quality report's
    #: accuracy-weighted-goodput ratio certifies the greedy ladder against.
    rungs: tuple[JobRung, ...] = ()
    task: Optional[Task] = None    # backref for committing placements

    @property
    def n_variants(self) -> int:
        return 1 + len(self.rungs)

    def rung(self, variant: int) -> tuple[float, Mapping[int, float],
                                          Mapping[int, float], float]:
        """(accuracy, durations, completion_durations, xfer) at a rung;
        variant 0 is the base, past-bottom clamps (the profiles'
        ``variant_profile`` contract — ladder-free jobs always resolve to
        the base)."""
        if variant <= 0 or not self.rungs:
            return (self.accuracy, self.durations,
                    self.completion_durations, self.xfer)
        r = self.rungs[min(variant, len(self.rungs)) - 1]
        return r.accuracy, r.durations, r.completion_durations, r.xfer


@dataclass(frozen=True)
class PlacementOption:
    """One admissible ``(job, device, cores, start)`` assignment."""

    job: int
    device: int
    cores: int
    start: float
    end: float                     # start + slot duration
    completion: float              # start + completion duration
    offloaded: bool
    weight: float = 0.0
    variant: int = 0               # ladder rung this option runs at
    accuracy: float = 1.0          # the rung's benchmark accuracy
    xfer: float = 0.0              # the rung's transfer (0 if local)


@dataclass
class OracleSolution:
    objective: float
    hp_completed: int
    completed: int
    goodput: float
    placements: dict[int, PlacementOption]   # job idx -> chosen option
    backend: str

    @property
    def lex(self) -> tuple[int, int, float]:
        """The lexicographic quality tuple the objective encodes."""
        return (self.hp_completed, self.completed, self.goodput)


class OracleInstance:
    """A frozen one-shot joint placement problem (see module docstring)."""

    def __init__(
        self,
        jobs: Sequence[OracleJob],
        device_profiles: Mapping[int, tuple[np.ndarray, np.ndarray]],
        link_profile: tuple[np.ndarray, np.ndarray],
        capacity: int,
        now: float,
        horizon: float,
        *,
        max_grid: int = MAX_GRID,
        max_options: int = MAX_OPTIONS,
        max_sums: int = MAX_SUMS,
    ) -> None:
        if not jobs:
            raise OracleInstanceError("instance has no jobs")
        self.jobs = list(jobs)
        self.capacity = capacity
        self.now = now
        self.horizon = horizon
        self.span = max(horizon - now, FEAS)
        self.device_profiles = dict(device_profiles)
        self.link_profile = link_profile
        self.max_grid = max_grid
        self.max_options = max_options
        self.max_sums = max_sums
        self._build_grid()
        self._build_options()
        self._build_capacity_rows()
        self._build_link_rows()

    # ------------------------------------------------------------------ #
    # Construction                                                       #
    # ------------------------------------------------------------------ #
    @classmethod
    def from_state(
        cls,
        state: NetworkState,
        net: NetworkConfig,
        tasks: Sequence[Task],
        now: float,
        **caps,
    ) -> "OracleInstance":
        """Freeze the current calendars + ``tasks`` into an instance.

        Every task is treated as released at ``now`` (the admission
        moment).  HP tasks are local-only on one core (the paper's rule);
        LP tasks may take any benchmarked core configuration on any
        device, paying one input transfer when offloaded.
        """
        jobs: list[OracleJob] = []
        for i, task in enumerate(tasks):
            prof = net.profile(task.task_type)
            if task.priority == Priority.HIGH:
                jobs.append(OracleJob(
                    idx=i, is_hp=True, source_device=task.source_device,
                    release=now, deadline=task.deadline,
                    durations={1: prof.hp_slot_time},
                    completion_durations={1: prof.hp_exec},
                    xfer=0.0, offloadable=False,
                    accuracy=prof.accuracy, task=task,
                ))
            else:
                durs = {c: prof.lp_slot_time(c) for c in prof.core_options}
                rungs = []
                for v in range(1, prof.n_variants):
                    rp = prof.variant_profile(v)
                    rd = {c: rp.lp_slot_time(c) for c in rp.core_options}
                    rungs.append(JobRung(rp.accuracy, rd, dict(rd),
                                         net.slot(rp.input_bytes)))
                jobs.append(OracleJob(
                    idx=i, is_hp=False, source_device=task.source_device,
                    release=now, deadline=task.deadline,
                    durations=durs, completion_durations=dict(durs),
                    xfer=net.slot(prof.input_bytes), offloadable=True,
                    accuracy=prof.accuracy, rungs=tuple(rungs), task=task,
                ))
        horizon = max(
            j.deadline + max(
                j.durations[c] - j.completion_durations[c]
                for c in j.durations
            )
            for j in jobs
        ) + FEAS
        profiles = {}
        for d in state.devices:
            if getattr(d, "is_up", True):
                profiles[d.device] = d.usage_segments(now, horizon)
            else:
                # DRAINING/DOWN devices take no new placements: present a
                # saturated profile so no placement option ever fits there.
                profiles[d.device] = (np.array([now]),
                                      np.array([d.capacity], dtype=np.int64))
        link_profile = state.link.usage_segments(now, horizon)
        return cls(jobs, profiles, link_profile,
                   capacity=state.devices[0].capacity if state.devices
                   else 4,
                   now=now, horizon=horizon, **caps)

    # -- candidate start grid ------------------------------------------- #
    def _free_link_segments(self) -> list[tuple[float, float]]:
        """Maximal free intervals of the link inside [now, horizon)."""
        starts, vals = self.link_profile
        segs: list[tuple[float, float]] = []
        n = len(starts)
        if n == 0:
            return [(self.now, self.horizon)]
        for i in range(n):
            if vals[i] == 0:
                t1 = float(starts[i])
                t2 = float(starts[i + 1]) if i + 1 < n else self.horizon
                if segs and abs(segs[-1][1] - t1) <= FEAS:
                    segs[-1] = (segs[-1][0], t2)
                else:
                    segs.append((t1, t2))
        return segs

    def _link_clear_point(self, release: float, demand: float) -> float:
        """Earliest ``t`` with ``demand`` seconds of free link in
        ``[release, t]`` — where a transfer backlog of that size clears."""
        acc = 0.0
        for t1, t2 in self._free_segments_cache:
            if t2 <= release:
                continue
            t1 = max(t1, release)
            if acc + (t2 - t1) >= demand - FEAS:
                return t1 + (demand - acc)
            acc += t2 - t1
        return self.horizon  # backlog never clears inside the window

    def free_link_time(self, a: float, b: float) -> float:
        """Free link seconds in [a, b]."""
        total = 0.0
        for t1, t2 in self._free_segments_cache:
            lo, hi = max(t1, a), min(t2, b)
            if hi > lo:
                total += hi - lo
        return total

    def _build_grid(self) -> None:
        jobs = self.jobs
        # Latest start any job could use (later points are never starts;
        # they are also not needed as capacity checkpoints, because options
        # only *end* there and usage never increases at an end).
        self._max_start = max(
            j.deadline - min(
                min(j.rung(v)[2].values()) for v in range(j.n_variants)
            )
            for j in jobs
        ) + FEAS
        base: set[float] = {round(self.now, _ROUND)}
        for starts, _ in self.device_profiles.values():
            base.update(round(float(t), _ROUND) for t in starts)
        lstarts, _ = self.link_profile
        base.update(round(float(t), _ROUND) for t in lstarts)
        for j in jobs:
            base.add(round(j.release, _ROUND))

        # Link-backlog clearing points: for every subset-sum of transfer
        # durations, the earliest time that much free link exists after
        # release.  (All jobs share the decision-time release.)
        self._free_segments_cache = self._free_link_segments()
        # Each offloadable job contributes AT MOST ONE of its rung xfers to
        # any schedule; unioning over the per-job alternatives closes the
        # sums over every admissible variant choice.
        xfer_sums: set[float] = {0.0}
        for j in jobs:
            if not j.offloadable:
                continue
            alts = sorted({round(j.rung(v)[3], _ROUND)
                           for v in range(j.n_variants)
                           if j.rung(v)[3] > FEAS})
            if not alts:
                continue
            add = {round(s + x, _ROUND)
                   for s in xfer_sums for x in alts
                   if s + x <= self.span}
            xfer_sums |= add
            if len(xfer_sums) > self.max_sums:
                raise OracleInstanceError(
                    f"transfer subset-sums exceed {self.max_sums}")
        release0 = min(j.release for j in jobs)
        for d in xfer_sums:  # replint: disable=determinism-set-iter (set-to-set accumulation into `base`; grid is sorted() at the end)
            if d > FEAS:
                base.add(round(self._link_clear_point(release0, d), _ROUND))

        # Closure under sums of slot durations: chains of back-to-back
        # chosen slots anchor later starts.
        deltas: list[tuple[float, ...]] = []
        for j in jobs:
            opts = sorted({round(dur, _ROUND)
                          for v in range(j.n_variants)
                          for dur in j.rung(v)[1].values()})
            deltas.append(tuple(opts))
        sums: set[float] = {0.0}
        limit = self._max_start - self.now
        for opts in deltas:
            new = set()
            for s in sums:  # replint: disable=determinism-set-iter (set-to-set accumulation; order-free union)
                for d in opts:
                    v = round(s + d, _ROUND)
                    if v <= limit:
                        new.add(v)
            sums |= new
            if len(sums) > self.max_sums:
                raise OracleInstanceError(
                    f"slot-duration subset-sums exceed {self.max_sums}")

        # The base x sums product can reach millions of points on instances
        # that are doomed anyway (ladder jobs carry up to 3x the distinct
        # durations, so `sums` saturates fast under load) — check the cap
        # INSIDE the loop so an over-sized instance fails in O(max_grid)
        # instead of building the whole product first.  The now-FEAS floor
        # is applied at insertion so the in-loop count is exact.
        floor = self.now - FEAS
        pts: set[float] = set()
        for b in base:  # replint: disable=determinism-set-iter (set-to-set accumulation into `pts`; grid is sorted() at the end)
            if b > self._max_start:
                if b <= self.horizon and b >= floor:
                    pts.add(b)        # capacity breakpoint past last start
                continue
            for s in sums:  # replint: disable=determinism-set-iter (set-to-set accumulation; order-free union)
                v = round(b + s, _ROUND)
                if v <= self._max_start and v >= floor:
                    pts.add(v)
            if len(pts) > self.max_grid:
                raise OracleInstanceError(
                    f"candidate grid exceeds {self.max_grid} points; "
                    "the oracle is for oracle-sized instances (DESIGN.md §13)")
        if len(pts) > self.max_grid:
            raise OracleInstanceError(
                f"candidate grid has {len(pts)} points (> {self.max_grid}); "
                "the oracle is for oracle-sized instances (DESIGN.md §13)")
        self.grid = np.array(sorted(pts))

        # Existing free capacity per device per grid segment (segment i is
        # [grid[i], grid[i+1]), the last running to the horizon).  Existing
        # usage is constant on each segment because every calendar
        # breakpoint is a grid point.
        g = self.grid
        nseg = len(g)
        self.free: dict[int, np.ndarray] = {}
        for dev, (starts, vals) in self.device_profiles.items():
            free = np.full(nseg, self.capacity, dtype=np.int64)
            if len(starts):
                idx = np.searchsorted(starts, g + FEAS, side="right") - 1
                inside = idx >= 0
                free[inside] = self.capacity - vals[idx[inside]]
            self.free[dev] = free

    # -- options -------------------------------------------------------- #
    def _goodput(self, accuracy: float, completion: float) -> float:
        """Accuracy-weighted earliness in [0, 1): the objective tiebreak."""
        frac = max(0.0, 1.0 - (completion - self.now) / self.span)
        return accuracy * min(frac, 1.0)

    def _build_options(self) -> None:
        jobs, g = self.jobs, self.grid
        n = len(jobs)
        # Weighted lexicographic objective: one HP completion outweighs
        # every possible LP gain (2n + 4 > 2n + 1), one completion of any
        # kind outweighs the total goodput tiebreak (2 > 1 > sum of
        # per-job goodput terms scaled by 1/(n+1)).  A completion counts
        # the same at any ladder rung — accuracy enters through the
        # goodput term only, so the oracle degrades exactly when doing so
        # buys a completion (or a better accuracy-earliness product).
        self.w_total = 2.0
        self.w_hp = 2.0 * n + 4.0
        options: list[PlacementOption] = []
        for j in jobs:
            devices = ([j.source_device] if j.is_hp else
                       sorted(self.device_profiles))
            for dev in devices:
                offloaded = (not j.is_hp) and dev != j.source_device
                if offloaded and not j.offloadable:
                    continue
                free = self.free[dev]
                for variant in range(j.n_variants):
                    acc, durs, comps, xfer = j.rung(variant)
                    for cores, dur in sorted(durs.items()):
                        comp_dur = comps[cores]
                        lo = j.release + (xfer if offloaded else 0.0)
                        hi = j.deadline - comp_dur + FEAS
                        if hi < lo - FEAS:
                            continue
                        i1 = int(np.searchsorted(g, lo - FEAS, side="left"))
                        i2 = int(np.searchsorted(g, hi + FEAS, side="right"))
                        for gi in range(i1, i2):
                            s = float(g[gi])
                            e = s + dur
                            # static feasibility vs *existing* occupancy
                            j2 = int(np.searchsorted(g, e - FEAS,
                                                     side="left"))
                            if j2 > gi and int(free[gi:j2].min()) < cores:
                                continue
                            comp = s + comp_dur
                            w = (self.w_total
                                 + (self.w_hp if j.is_hp else 0.0)
                                 + self._goodput(acc, comp) / (n + 1.0))
                            options.append(PlacementOption(
                                j.idx, dev, cores, s, e, comp, offloaded,
                                w, variant, acc,
                                xfer if offloaded else 0.0))
                            if len(options) > self.max_options:
                                raise OracleInstanceError(
                                    f"option count exceeds "
                                    f"{self.max_options}; oracle-sized "
                                    "instances only (DESIGN.md §13)")
        self.options = options
        self.by_job: list[list[int]] = [[] for _ in jobs]
        for oi, o in enumerate(options):
            self.by_job[o.job].append(oi)

    # -- constraint rows ------------------------------------------------ #
    def _build_capacity_rows(self) -> None:
        """(device, grid-segment) checkpoints covered by >= 1 option."""
        g = self.grid
        self._opt_span: list[tuple[int, int]] = []
        covered: dict[tuple[int, int], list[int]] = {}
        for oi, o in enumerate(self.options):
            i1 = int(np.searchsorted(g, o.start - FEAS, side="left"))
            i2 = int(np.searchsorted(g, o.end - FEAS, side="left"))
            self._opt_span.append((i1, i2))
            for seg in range(i1, i2):
                covered.setdefault((o.device, seg), []).append(oi)
        self.capacity_rows: list[tuple[list[int], int]] = []
        self._cap_row_of: dict[tuple[int, int], int] = {}
        for (dev, seg), ois in sorted(covered.items()):
            rhs = int(self.free[dev][seg])
            if sum(self.options[oi].cores for oi in ois) <= rhs:
                continue                        # can never bind
            self._cap_row_of[(dev, seg)] = len(self.capacity_rows)
            self.capacity_rows.append((ois, rhs))

    def _build_link_rows(self) -> None:
        """Preemptive-EDF interval conditions: for release ``a`` and
        candidate start ``b``, transfers of chosen offloaded options with
        release >= a and start <= b must fit in the free link time of
        [a, b]."""
        offload = [oi for oi, o in enumerate(self.options) if o.offloaded]
        self.link_rows: list[tuple[list[int], list[float], float]] = []
        if not offload:
            return
        releases = sorted({self.jobs[self.options[oi].job].release
                           for oi in offload})
        starts = sorted({self.options[oi].start for oi in offload})
        for a in releases:
            for b in starts:
                if b < a - FEAS:
                    continue
                ois = [oi for oi in offload
                       if self.jobs[self.options[oi].job].release >= a - FEAS
                       and self.options[oi].start <= b + FEAS]
                if not ois:
                    continue
                xf = [self.options[oi].xfer for oi in ois]
                rhs = self.free_link_time(a, b)
                if sum(xf) <= rhs + LINK_TOL:
                    continue                    # can never bind
                self.link_rows.append((ois, xf, rhs))

    # ------------------------------------------------------------------ #
    # Solving                                                            #
    # ------------------------------------------------------------------ #
    def solve(self, backend: str = "auto") -> OracleSolution:
        if backend == "auto":
            space = 1.0
            for ois in self.by_job:
                space *= len(ois) + 1
            backend = ("brute" if space <= _BRUTE_SPACE
                       or len(self.jobs) <= _BRUTE_JOBS
                       or not _have_scipy_milp() else "milp")
        if backend == "brute":
            return self._solve_brute()
        if backend == "milp":
            return self._solve_milp()
        if backend == "cpsat":
            return self._solve_cpsat()
        raise ValueError(f"unknown oracle backend {backend!r}")

    def _solution(self, chosen: Sequence[int], backend: str) -> OracleSolution:
        placements = {self.options[oi].job: self.options[oi] for oi in chosen}
        hp = sum(1 for o in placements.values() if self.jobs[o.job].is_hp)
        goodput = sum(self._goodput(o.accuracy, o.completion)
                      for o in placements.values())
        objective = sum(self.options[oi].weight for oi in chosen)
        return OracleSolution(objective, hp, len(placements), goodput,
                              placements, backend)

    # -- brute force (the oracle's own correctness oracle) -------------- #
    def _solve_brute(self) -> OracleSolution:
        jobs = self.jobs
        order = sorted(
            range(len(jobs)),
            key=lambda ji: -max(
                (self.options[oi].weight for oi in self.by_job[ji]),
                default=0.0),
        )
        # per-job options, best weight first (first full descent is greedy)
        opts = [sorted(self.by_job[ji],
                       key=lambda oi: -self.options[oi].weight)
                for ji in order]
        suffix = [0.0] * (len(order) + 1)
        for k in range(len(order) - 1, -1, -1):
            best = max((self.options[oi].weight for oi in opts[k]),
                       default=0.0)
            suffix[k] = suffix[k + 1] + best

        free = {d: arr.astype(np.int64).copy()
                for d, arr in self.free.items()}
        link_used = [0.0] * len(self.link_rows)
        link_rows_of: dict[int, list[int]] = {}
        for ri, (ois, _, _) in enumerate(self.link_rows):
            for oi in ois:
                link_rows_of.setdefault(oi, []).append(ri)

        best_obj = -1.0
        best_chosen: list[int] = []
        chosen: list[int] = []

        def feasible(oi: int) -> bool:
            o = self.options[oi]
            i1, i2 = self._opt_span[oi]
            if i2 > i1 and int(free[o.device][i1:i2].min()) < o.cores:
                return False
            for ri in link_rows_of.get(oi, ()):
                if link_used[ri] + o.xfer > self.link_rows[ri][2] + LINK_TOL:
                    return False
            return True

        def apply(oi: int, sign: int) -> None:
            o = self.options[oi]
            i1, i2 = self._opt_span[oi]
            free[o.device][i1:i2] -= sign * o.cores
            for ri in link_rows_of.get(oi, ()):
                link_used[ri] += sign * o.xfer

        def dfs(k: int, acc: float) -> None:
            nonlocal best_obj, best_chosen
            if acc + suffix[k] <= best_obj + 1e-12:
                return
            if k == len(order):
                best_obj = acc
                best_chosen = list(chosen)
                return
            for oi in opts[k]:
                if not feasible(oi):
                    continue
                apply(oi, 1)
                chosen.append(oi)
                dfs(k + 1, acc + self.options[oi].weight)
                chosen.pop()
                apply(oi, -1)
            dfs(k + 1, acc)                     # leave job k unplaced

        dfs(0, 0.0)
        return self._solution(best_chosen, "brute")

    # -- MILP (scipy / HiGHS) ------------------------------------------- #
    def _solve_milp(self) -> OracleSolution:
        try:
            from scipy import sparse
            from scipy.optimize import Bounds, LinearConstraint, milp
        except ImportError as exc:               # pragma: no cover
            raise OracleInstanceError(
                "scipy.optimize.milp unavailable; use the brute backend"
            ) from exc
        n_opts = len(self.options)
        if n_opts == 0:
            return self._solution([], "milp")
        rows_i: list[int] = []
        cols: list[int] = []
        vals: list[float] = []
        ub: list[float] = []
        row = 0
        for ois in self.by_job:                 # one option per job
            if not ois:
                continue
            for oi in ois:
                rows_i.append(row)
                cols.append(oi)
                vals.append(1.0)
            ub.append(1.0)
            row += 1
        for ois, rhs in self.capacity_rows:     # device capacity
            for oi in ois:
                rows_i.append(row)
                cols.append(oi)
                vals.append(float(self.options[oi].cores))
            ub.append(float(rhs))
            row += 1
        for ois, xf, rhs in self.link_rows:     # link intervals
            for oi, x in zip(ois, xf):
                rows_i.append(row)
                cols.append(oi)
                vals.append(x)
            ub.append(rhs + LINK_TOL)
            row += 1
        A = sparse.csr_matrix((vals, (rows_i, cols)), shape=(row, n_opts))
        c = -np.array([o.weight for o in self.options])
        res = milp(
            c,
            constraints=LinearConstraint(A, -np.inf, np.array(ub)),
            integrality=np.ones(n_opts),
            bounds=Bounds(0.0, 1.0),
        )
        if res.x is None:                        # pragma: no cover
            raise OracleInstanceError(f"MILP solve failed: {res.message}")
        chosen = [oi for oi in range(n_opts) if res.x[oi] > 0.5]
        return self._solution(chosen, "milp")

    # -- CP-SAT (optional; requires ortools) ---------------------------- #
    def _solve_cpsat(self) -> OracleSolution:
        if not have_ortools():
            raise OracleInstanceError(
                "ortools is not installed; the cpsat backend is optional — "
                "use 'milp', 'brute' or 'auto'")
        from ortools.sat.python import cp_model
        SCALE = 10**9
        model = cp_model.CpModel()
        xs = [model.NewBoolVar(f"x{oi}") for oi in range(len(self.options))]
        for ois in self.by_job:
            if ois:
                model.AddAtMostOne(xs[oi] for oi in ois)
        for ois, rhs in self.capacity_rows:
            model.Add(sum(self.options[oi].cores * xs[oi]
                          for oi in ois) <= rhs)
        for ois, xf, rhs in self.link_rows:
            model.Add(sum(int(round(x * SCALE)) * xs[oi]
                          for oi, x in zip(ois, xf))
                      <= int(round((rhs + LINK_TOL) * SCALE)))
        model.Maximize(sum(int(round(o.weight * SCALE)) * x
                           for o, x in zip(self.options, xs)))
        solver = cp_model.CpSolver()
        status = solver.Solve(model)
        if status not in (cp_model.OPTIMAL,):    # pragma: no cover
            raise OracleInstanceError(f"CP-SAT solve status {status}")
        chosen = [oi for oi in range(len(xs))
                  if solver.BooleanValue(xs[oi])]
        return self._solution(chosen, "cpsat")

    # ------------------------------------------------------------------ #
    # Verification + scoring (tests / quality report)                    #
    # ------------------------------------------------------------------ #
    def verify(self, sol: OracleSolution) -> None:
        """Independently re-check a solution against the instance model
        (deadlines, capacity vs existing occupancy, link intervals).
        Raises AssertionError on any violation."""
        placements = list(sol.placements.values())
        for o in placements:
            j = self.jobs[o.job]
            assert o.completion <= j.deadline + 1e-6, \
                f"job {o.job} misses deadline"
            assert o.start >= j.release - 1e-9
            if o.offloaded:
                assert j.offloadable
        for dev in self.device_profiles:
            events: list[tuple[float, int]] = []
            for o in placements:
                if o.device == dev:
                    events.append((o.start, o.cores))
                    events.append((o.end, -o.cores))
            for t, _ in sorted(events):
                load = sum(o.cores for o in placements
                           if o.device == dev
                           and o.start <= t + FEAS and o.end > t + FEAS)
                gi = int(np.searchsorted(self.grid, t + FEAS, side="right")) - 1
                existing = self.capacity - int(self.free[dev][max(gi, 0)])
                assert load + existing <= self.capacity + 1e-9, \
                    f"device {dev} over capacity at t={t}"
        offl = [o for o in placements if o.offloaded]
        for a in sorted({self.jobs[o.job].release for o in offl}):
            for b in sorted({o.start for o in offl}):
                demand = sum(o.xfer for o in offl
                             if self.jobs[o.job].release >= a - FEAS
                             and o.start <= b + FEAS)
                assert demand <= self.free_link_time(a, b) + 1e-6, \
                    f"link overflow on [{a}, {b}]"

    def score_tasks(self, tasks: Sequence[Task]) -> tuple[float, tuple]:
        """Score a policy's committed placements of ``tasks`` (parallel to
        the instance's jobs) under the oracle objective.  A task counts as
        completed when it holds a slot whose model completion time meets
        the deadline — exactly the instance's completion rule.  A task
        admitted at a ladder rung is scored at that rung's completion
        duration and accuracy (``task.variant``, DESIGN.md §17)."""
        obj, hp, total, good = 0.0, 0, 0, 0.0
        n = len(self.jobs)
        for j, task in zip(self.jobs, tasks):
            if task.t_start is None or task.cores is None:
                continue
            if task.state not in (TaskState.ALLOCATED, TaskState.RUNNING,
                                  TaskState.COMPLETED):
                continue
            acc, _, comps, _ = j.rung(task.variant)
            comp = task.t_start + comps.get(task.cores, float("inf"))
            if comp > j.deadline + 1e-6:
                continue
            g = self._goodput(acc, comp)
            obj += (self.w_total + (self.w_hp if j.is_hp else 0.0)
                    + g / (n + 1.0))
            hp += 1 if j.is_hp else 0
            total += 1
            good += g
        return obj, (hp, total, good)


# ====================================================================== #
# The registered policy                                                  #
# ====================================================================== #
@register_policy("oracle")
class OraclePolicy(CalendarPolicy):
    """Per-decision application of the placement oracle (DESIGN.md §13).

    HP admission uses the closed-form instance optimum — the earliest
    feasible 1-core slot on the source device (earlier is strictly better
    under the goodput tiebreak, and feasibility is monotone).  Each LP
    request is solved as one joint oracle instance over its pending tasks;
    an oversized instance falls back to per-task singleton instances.

    The policy never preempts and pays no allocation/update messages —
    its per-run metrics are a *reference*, not a physical discipline.
    Offloaded transfers are committed as (possibly fragmented) link
    reservations realising the preemptive-EDF schedule the instance
    certified, so successive decisions see real link contention.
    """

    def __init__(self, n_devices: int, net: NetworkConfig, *,
                 capacity: int = 4, metrics: Optional[Metrics] = None,
                 backend: str = "auto", **_ignored) -> None:
        super().__init__(n_devices, net, capacity=capacity, metrics=metrics)
        self.backend = backend

    # -- HP: closed-form instance optimum ------------------------------- #
    def decide_hp(self, task: Task, now: float) -> Decision:
        self.state.gc(now)
        prof = self.net.profile(task.task_type)
        dev = self.state.devices[task.source_device]
        if not dev.is_up:
            # HP runs on its (DRAINING/DOWN) home device only: reject.
            return Decision(DecisionStatus.REJECTED, failed=[task])
        t1 = dev.earliest_fit(prof.hp_slot_time, now, 1)
        if t1 + prof.hp_exec > task.deadline:
            return Decision(DecisionStatus.REJECTED, failed=[task])
        t2 = t1 + prof.hp_slot_time
        dev.reserve(t1, t2, 1, task)
        task.state = TaskState.ALLOCATED
        task.device, task.cores = task.source_device, 1
        task.t_start, task.t_end, task.offloaded = t1, t2, False
        alloc = Allocation(task, task.source_device, t1, t2, 1, False)
        return Decision(DecisionStatus.ADMITTED, allocations=[alloc],
                        predicted_completion=t2)

    # -- LP: one joint instance per request ----------------------------- #
    def decide_lp(self, request: LowPriorityRequest, now: float) -> Decision:
        self.state.gc(now)
        pending = [t for t in request.tasks
                   if t.state == TaskState.PENDING]
        if not pending:
            return Decision(DecisionStatus.REJECTED)
        placed = self._solve_and_commit(pending, now)
        dec = Decision(DecisionStatus.REJECTED)
        for task in pending:
            alloc = placed.get(task)
            if alloc is None:
                dec.failed.append(task)
            else:
                dec.allocations.append(alloc)
                dec.status = DecisionStatus.ADMITTED
        if dec.allocations:
            dec.predicted_completion = max(a.t_end for a in dec.allocations)
        return dec

    def _solve_and_commit(
        self, tasks: list[Task], now: float
    ) -> dict[Task, Allocation]:
        try:
            groups: list[list[Task]] = [tasks]
            inst = OracleInstance.from_state(self.state, self.net, tasks, now)
        except OracleInstanceError:
            groups = [[t] for t in tasks]       # oversized: singletons
        placed: dict[Task, Allocation] = {}
        for group in groups:
            try:
                if group is not tasks:
                    inst = OracleInstance.from_state(
                        self.state, self.net, group, now)
                sol = inst.solve(self.backend)
            except OracleInstanceError:
                continue                        # group stays unplaced
            for o in sorted(sol.placements.values(), key=lambda o: o.start):
                task = group[o.job]
                dev = self.state.devices[o.device]
                dev.reserve(o.start, o.end, o.cores, task)
                if o.offloaded:
                    # o.xfer is the chosen rung's input transfer (the base
                    # profile's for variant 0 — the historic behaviour).
                    self._commit_transfer(task, now, o.start, o.xfer)
                task.state = TaskState.ALLOCATED
                task.device, task.cores = o.device, o.cores
                task.t_start, task.t_end = o.start, o.end
                task.offloaded = o.offloaded
                task.variant = o.variant
                placed[task] = Allocation(task, o.device, o.start, o.end,
                                          o.cores, o.offloaded)
        return placed

    def _commit_transfer(self, task: Task, release: float, start: float,
                         xfer: float) -> None:
        """Realise the certified preemptive transfer as (possibly
        fragmented) link reservations, earliest-free-first."""
        link = self.state.link
        remaining = xfer
        starts, vals = link.usage_segments(release, start)
        n = len(starts)
        if n == 0:                              # link untouched: one piece
            take = min(start - release, remaining)
            if take > 1e-12:
                link.reserve(release, release + take,
                             ("oxfer", task.task_id))
                remaining -= take
        for i in range(n):
            if remaining <= 1e-9:
                break
            if vals[i] > 0:
                continue
            t1 = float(starts[i])
            t2 = float(starts[i + 1]) if i + 1 < n else start
            take = min(t2 - t1, remaining)
            if take <= 1e-12:
                continue
            link.reserve(t1, t1 + take, ("oxfer", task.task_id))
            remaining -= take
        # Residual < 1e-6 s can remain from float round-off; the instance
        # certified feasibility, so anything larger indicates a model bug.
        assert remaining <= 1e-6 + FEAS, (
            f"uncommittable transfer residual {remaining} for task "
            f"{task.task_id}")
