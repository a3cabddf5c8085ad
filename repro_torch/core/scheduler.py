"""The paper's two scheduling algorithms (§4), scaled for large networks.

High-priority allocation (`allocate_high_priority`): local-only, single-core,
allocated at arrival time; optionally backed by the deadline-aware preemption
mechanism (victims are conflicting LP reservations, farthest deadline first,
each followed by a reallocation attempt).

Low-priority allocation (`allocate_low_priority`): offloadable,
multi-configuration (2/4-core horizontal partitioning), searching over the
completion time-points of already-allocated tasks up to the request deadline,
with partial allocation, even spreading (least-loaded device first) and a
core-upgrade pass.

Complexity (DESIGN.md §2.3, paper §6.3)
---------------------------------------
Every probe the algorithms issue (`fits`, `load`, `earliest_slot`,
`completion_times`) is answered by the skyline calendars in
O(log n + k) for k structures intersecting the probed window, so:

* HP admission is O(log n + conflicts) per call — the preemption loop only
  enumerates reservations on the *source device*, and through the
  vectorized preemption plane (DESIGN.md §12) that enumeration is ONE
  overlap mask over the device's LP-reservation mirror plus one masked
  argmin per victim, with incremental refit (`_HPWindowGrid`) instead of a
  full ``fits`` re-probe after each eviction.  The scalar loop is kept as
  the differential reference (``preemption_plane=False``).
* LP admission is O(T · D · (log n + k)) for T time-points searched and D
  devices, with T bounded by the completion points inside the request's
  deadline window rather than every reservation in the network.
* `allocate_low_priority_batch` admits a whole arrival burst in ONE
  `gc` + ONE network-wide time-point sweep (a monotone heap that also absorbs
  completion points created by the batch itself), instead of re-running the
  full sweep per request — the per-request cost at high arrival rates drops
  by roughly the batch size (measured in benchmarks/scheduler_micro.py).

Victim lifecycle: EVERY evicted victim gets the best-effort reallocation
pass (`_reallocate_victims`) — also when the HP admission itself ultimately
fails after its preemptions (deadline slipped or non-LP blockers remain).
A victim is never left stranded in ``PREEMPTED``: it either re-enters
``ALLOCATED`` with a fresh slot before its deadline or transitions to
``FAILED``, and ``realloc_success``/``realloc_failure`` account for both
paths (the failure path was a PR 5 bugfix).

Link-slot hygiene: every committed allocation records its link reservations
(`alloc`/`xfer`/`update` messages); when a victim is preempted, its
still-pending link slots are cancelled so the shared link does not
permanently inflate with dead traffic (a seed bug — see
tests/test_scheduler.py::test_preemption_cancels_victim_link_slots).
"""
from __future__ import annotations

import heapq
import itertools
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .calendar import EPS, NetworkState, Reservation
from .metrics import Metrics
from .network import NetworkConfig
from .task import LowPriorityRequest, Priority, Task, TaskState
from .victims import GOOD_STATES, plan_shrink, rank_victims, victim_sort_key

#: Victim-selection rules accepted by the preemption mechanism (also the
#: options surfaced by ``ScenarioConfig`` validation).  ``degrade_shrink``
#: ranks like ``farthest_deadline`` but first tries to shrink the chosen
#: victim in place down its variant ladder (DESIGN.md §17), evicting only
#: when no viable shrink exists.
VICTIM_POLICIES = ("farthest_deadline", "weakest_set", "degrade_shrink")


def _dev_up(dev) -> bool:
    """Placement eligibility of one device calendar.  The seed reference
    calendars (calendar_reference) predate the lifecycle plane and are
    treated as always UP."""
    return getattr(dev, "is_up", True)


@dataclass
class Allocation:
    """A committed placement decision for a single task."""

    task: Task
    device: int
    t_start: float
    t_end: float                       # end of reserved slot (incl. padding)
    cores: int
    offloaded: bool
    link_slots: list[Reservation] = field(default_factory=list)


@dataclass
class HPResult:
    success: bool
    allocation: Optional[Allocation] = None
    preempted: list[Task] = field(default_factory=list)
    reallocations: list[Allocation] = field(default_factory=list)


@dataclass
class LPResult:
    allocations: list[Allocation] = field(default_factory=list)
    failed: list[Task] = field(default_factory=list)


class LinkSlotRegistry:
    """Link reservations per task, so a discipline can cancel a preempted or
    reallocated task's still-pending messages (alloc/xfer/update).  Shared by
    ``PreemptionAwareScheduler`` and the calendar-backed policy plugins."""

    def __init__(self) -> None:
        self._slots: dict[int, list[Reservation]] = {}
        self._prune_at = 256

    def record(self, task_id: int, slots: list[Reservation]) -> None:
        self._slots[task_id] = slots

    def pop(self, task_id: int) -> list[Reservation]:
        return self._slots.pop(task_id, [])

    def cancel_pending(self, link, task_id: int, now: float) -> None:
        """Cancel the task's link slots that still lie in the future."""
        for slot in self.pop(task_id):
            if slot.t2 > now + EPS:
                link.cancel(slot)

    def prune(self, now: float) -> None:
        """Drop records whose messages all lie in the past.  Amortised
        O(1): runs only when the registry doubled."""
        if len(self._slots) <= self._prune_at:
            return
        self._slots = {
            tid: slots
            for tid, slots in self._slots.items()
            if any(s.t2 > now for s in slots)
        }
        self._prune_at = max(256, 2 * len(self._slots))


class _HPWindowGrid:
    """Incremental refit tracker for one HP admission.

    The scalar eviction loop re-probes ``dev.fits(t1, t2, 1)`` after every
    eviction, paying a skyline flush (one splice per buffered release) per
    probe.  This grid instead materialises the usage segments ONCE over an
    *extended* horizon ``[t1, cover)`` — the admission window plus the
    forward drift the loop's own preempt messages can cause (each message
    occupies the link and pushes the re-derived window later, never
    earlier) — cut at every live LP candidate's endpoints so any future
    eviction aligns with existing breakpoints.  Each eviction is then an
    exact usage-mass delta over its segment range, and each refit a
    searchsorted slice-max, both O(covered segments) C-level with no
    skyline interaction at all.

    Integer arithmetic over the same EPS-shrunk windows every skyline
    query uses, so ``fits_window`` is bit-identical to ``dev.fits`` after
    the same evictions (fuzzed in tests/test_preemption_plane.py).
    ``fits_window`` returns None when the window drifted past ``cover`` —
    the caller rebuilds (a cold rebuild is always exact: the flushed
    skyline already reflects every eviction so far).
    """

    __slots__ = ("a", "cover", "cap", "bp", "vals")

    def __init__(self, dev, t1: float, cover: float,
                 cand_t1: np.ndarray, cand_t2: np.ndarray,
                 alive: np.ndarray) -> None:
        a = t1 + EPS
        self.a, self.cover = a, cover
        self.cap = dev.capacity
        starts, vals = dev.usage_segments(a, cover)
        if starts.size:
            cuts = np.concatenate((cand_t1[alive], cand_t2[alive]))
            cuts = cuts[(cuts > a) & (cuts < cover)]
            if cuts.size:
                bp = np.unique(np.concatenate((starts, cuts)))
                vals = vals[np.searchsorted(starts, bp, side="right") - 1]
                starts = bp
        self.bp = starts
        self.vals = vals.astype(np.int64, copy=True)

    def fits_window(self, t1: float, t2: float, cores: int):
        """Whether ``cores`` more cores fit everywhere in [t1, t2)
        (EPS-shrunk, like every calendar query); None = window no longer
        covered, rebuild required."""
        a, b = t1 + EPS, t2 - EPS
        if a < self.a - EPS or b > self.cover:
            return None
        if b <= a or self.vals.size == 0:
            return True
        bp = self.bp
        i1 = int(bp.searchsorted(a, side="right")) - 1
        i2 = int(bp.searchsorted(b, side="left"))
        if i1 < 0:
            i1 = 0
        return int(self.vals[i1:i2].max()) + cores <= self.cap

    def evict(self, vt1: float, vt2: float, amount: int) -> None:
        """Subtract an evicted reservation's usage mass from the grid."""
        if self.vals.size == 0:
            return
        bp = self.bp
        j1 = int(bp.searchsorted(vt1 if vt1 > self.a else self.a,
                                 side="left"))
        j2 = int(bp.searchsorted(vt2, side="left"))
        self.vals[j1:j2] -= amount


class PreemptionAwareScheduler:
    """Controller-side scheduler over the time-slotted network state."""

    def __init__(
        self,
        state: NetworkState,
        net: NetworkConfig,
        preemption: bool = True,
        metrics: Optional[Metrics] = None,
        on_preempt: Optional[Callable[[Task], None]] = None,
        victim_policy: str = "farthest_deadline",
        allow_offload: bool = True,
        preemption_plane: bool = True,
        degrade: bool = False,
    ) -> None:
        self.state = state
        self.net = net
        self.preemption = preemption
        self.allow_offload = allow_offload
        self.metrics = metrics if metrics is not None else Metrics()
        # Degrade-before-reject (DESIGN.md §17): when an LP task cannot be
        # placed at its current ladder rung, retry the admission down the
        # task type's variant ladder before settling it FAILED.  Off by
        # default — every golden path runs reject-only.
        self.degrade = degrade
        # Callback into the runtime so a running victim is actually stopped.
        self.on_preempt = on_preempt
        # Victim selection among conflicting LP reservations:
        #   "farthest_deadline"  the paper's §4 rule.
        #   "weakest_set"        the paper's §8 future-work proposal
        #                        (beyond-paper): prefer a victim whose request
        #                        set is least likely to complete anyway —
        #                        fewest healthy siblings — so preemption
        #                        destroys the least prospective frame value;
        #                        tie-break by farthest deadline.
        #   "degrade_shrink"     degrade-instead-of-evict (DESIGN.md §17):
        #                        same ranking as farthest_deadline, but the
        #                        chosen victim is shrunk in place down its
        #                        variant ladder when viable (core/victims.py
        #                        plan_shrink), evicted only otherwise.
        if victim_policy not in VICTIM_POLICIES:
            raise ValueError(
                f"unknown victim_policy {victim_policy!r}; expected one of "
                + ", ".join(VICTIM_POLICIES)
            )
        self.victim_policy = victim_policy
        self._degrade_evict = victim_policy == "degrade_shrink"
        self._requests: dict[int, LowPriorityRequest] = {}
        self._requests_prune_at = 256
        # link reservations per task, so preemption/reallocation can cancel
        # a task's still-pending xfer/update messages.
        self.links = LinkSlotRegistry()
        # The vectorized network-wide probe plane (calendar.py): one pass
        # answers fits/loads/earliest-fit for EVERY device.  The reference
        # network state (calendar_reference.py) predates it, so the
        # benchmarks can still drive this scheduler over the seed calendars
        # through the per-device scalar path.
        self._plane_ok = hasattr(state, "probe_plane")
        # The vectorized preemption plane (DESIGN.md §12): HP eviction via
        # overlap masks + one-pass victim ranking over each device's
        # LP-reservation mirror, with incremental refit.  Decision-identical
        # to the scalar loop (`_evict_conflicts_scalar`, kept as the
        # differential reference); ``preemption_plane=False`` forces the
        # scalar path for differential tests and benchmarks.
        self._preempt_plane = (preemption_plane and bool(state.devices)
                               and hasattr(state.devices[0], "lp_mirror"))
        # Probe accounting (tests/test_grid_dedup.py, DESIGN.md §11): how
        # many per-task placement probes ran, how many time-point rounds the
        # LP sweeps walked, and how much grid traffic the exact-duplicate
        # dedup removed.  Plain counters — negligible overhead, always on.
        self.lp_probes = 0
        self.grid_rounds = 0
        self.grid_pushes = 0
        self.grid_dups_skipped = 0
        self._dedup_grid = True

    # ------------------------------------------------------------------ #
    # High-priority algorithm                                            #
    # ------------------------------------------------------------------ #
    def allocate_high_priority(self, task: Task, now: float) -> HPResult:
        t_wall = _time.perf_counter()
        self.state.gc(now)
        self.links.prune(now)
        result = self._hp_inner(task, now)
        elapsed = _time.perf_counter() - t_wall
        if result.preempted:
            self.metrics.t_hp_preempt.append(elapsed)
        else:
            self.metrics.t_hp_initial.append(elapsed)
        return result

    def _hp_inner(self, task: Task, now: float) -> HPResult:
        net, link = self.net, self.state.link
        dev = self.state.devices[task.source_device]
        if not _dev_up(dev):
            # HP execution is source-local (paper rule): a DRAINING/DOWN
            # home device takes no new placements, so admission fails.
            return HPResult(False)
        prof = net.profile(task.task_type)
        msg_dur = net.slot(net.msg.hp_alloc)

        def placement():
            """(msg_t1, t1, t2) for the earliest feasible window, or None if
            the deadline can't be met.  Recomputed after every preemption —
            each preempt message occupies the link and pushes the allocation
            message (and hence the processing window) later."""
            msg_t1 = link.earliest_slot(msg_dur, now)
            arrival = msg_t1 + msg_dur
            if arrival + prof.hp_exec > task.deadline:
                return None
            return msg_t1, arrival, arrival + prof.hp_slot_time

        plan = placement()
        if plan is None:
            return HPResult(False)          # can't meet the deadline at all
        msg_t1, t1, t2 = plan

        if dev.fits(t1, t2, 1):
            return HPResult(True, self._commit_hp(task, msg_t1, msg_dur, t1, t2))

        if not self.preemption:
            return HPResult(False)

        # 3. preemption: evict conflicting LP tasks in victim-policy order
        # until the window fits — through the vectorized preemption plane
        # (DESIGN.md §12) or the scalar differential reference.
        e_wall = _time.perf_counter()
        if self._preempt_plane:
            plan, preempted, shrunk = self._evict_conflicts_plane(
                dev, plan, placement, now)
        else:
            plan, preempted, shrunk = self._evict_conflicts_scalar(
                dev, plan, placement, now)
        self.metrics.t_evict.append(_time.perf_counter() - e_wall)

        if plan is None or not dev.fits(plan[1], plan[2], 1):
            # The HP task ultimately cannot be placed — but its victims were
            # already evicted.  They STILL get the reallocation pass (each
            # one a placement attempt before its own deadline, else FAILED):
            # returning them stranded in PREEMPTED forever broke the paper's
            # reallocation guarantee and skewed the realloc accounting
            # (tests/test_victim_lifecycle.py::
            # test_failed_hp_admission_still_reallocates_victims).
            return HPResult(
                False, preempted=preempted + shrunk,
                reallocations=self._reallocate_victims(preempted, now)
                + self._rearm_shrunk(shrunk))
        msg_t1, t1, t2 = plan

        alloc = self._commit_hp(task, msg_t1, msg_dur, t1, t2)

        # 4. attempt to reallocate every victim before its deadline.
        # Shrunk victims ride the same two result lists as a
        # preempted-then-reallocated victim: ``preempted`` cancels their
        # stale execution event, ``reallocations`` re-arms the shortened
        # slot — to the dispatcher the two are indistinguishable.
        return HPResult(True, alloc, preempted + shrunk,
                        self._reallocate_victims(preempted, now)
                        + self._rearm_shrunk(shrunk))

    # ------------------------------------------------------------------ #
    # Preemption: eviction loop (vectorized plane + scalar reference)    #
    # ------------------------------------------------------------------ #
    def _preempt_victim(self, dev, victim: Task, amount: int,
                        now: float) -> None:
        """Evict one victim — the side effects both eviction loops share."""
        net, link = self.net, self.state.link
        dev.release(victim)
        # Cancel the victim's still-pending link slots (xfer/update):
        # leaving them reserved would permanently inflate link congestion
        # with traffic for a task that will never run in that slot.
        self.links.cancel_pending(link, victim.task_id, now)
        victim.state = TaskState.PREEMPTED
        victim.preempt_count += 1
        self.metrics.preemptions += 1
        self.metrics.preempted_by_cores[amount] += 1
        # preemption message to the executing device
        pre_dur = net.slot(net.msg.preempt)
        link.reserve_earliest(pre_dur, now, ("preempt", victim.task_id))
        if self.on_preempt is not None:
            self.on_preempt(victim)

    def _shrink_victim(self, dev, victim: Task, new_end: float,
                       now: float) -> None:
        """Degrade-instead-of-evict one victim (DESIGN.md §17): drop it to
        the next ladder rung at its current core count and truncate its
        reservation to the shorter slot.  ``truncate`` updates the skyline
        AND the preemption plane's LP-mirror row in place (a re-reserve
        would append a fresh mirror row behind the eviction loop's column
        views).  The victim stays ALLOCATED; its link slots stay reserved
        (the input already shipped at the admitted rung's size, and the
        update slot at the old end is simply a late update).  A resize
        notification occupies the link like a preempt message, so the
        caller must re-derive the HP window afterwards."""
        net, link = self.net, self.state.link
        dev.truncate(victim, new_end)
        victim.variant += 1
        victim.t_end = new_end
        self.metrics.degrade_shrinks += 1
        self.metrics.lp_degraded += 1
        msg_dur = net.slot(net.msg.preempt)
        link.reserve_earliest(msg_dur, now, ("degrade", victim.task_id))

    def _try_shrink(self, dev, victim: Task, t1: float, t2: float,
                    now: float) -> bool:
        """Shrink ``victim`` out of the HP window [t1, t2) when the
        ``degrade_shrink`` policy is active and a viable plan exists."""
        if not self._degrade_evict:
            return False
        new_end = plan_shrink(victim, self.net.profile(victim.task_type),
                              t1, t2, now, EPS)
        if new_end is None:
            return False
        self._shrink_victim(dev, victim, new_end, now)
        return True

    def _rearm_shrunk(self, shrunk: list[Task]) -> list[Allocation]:
        """Fresh Allocation records for shrunk victims, so the dispatcher
        re-arms their (shortened) slots exactly like reallocated victims."""
        return [Allocation(t, t.device, t.t_start, t.t_end, t.cores,
                           t.offloaded) for t in shrunk]

    def _evict_conflicts_scalar(self, dev, plan, placement, now: float):
        """The scalar eviction loop, kept verbatim as the differential
        reference for the vectorized plane (the `calendar_reference`
        pattern): per iteration it rebuilds the conflicting-LP list with a
        Python sweep over every reservation on the device and picks one
        victim with ``min()``.  Returns ``(plan, preempted, shrunk)``;
        ``plan`` is None when the preempt messages pushed the window past
        the task's deadline."""
        msg_t1, t1, t2 = plan
        preempted: list[Task] = []
        shrunk: list[Task] = []
        while not dev.fits(t1, t2, 1):
            conflicts = [
                r
                for r in dev.reservations()
                if r.overlaps(t1, t2)
                and isinstance(r.tag, Task)
                and r.tag.priority == Priority.LOW
            ]
            if not conflicts:
                break
            victim_res = min(conflicts, key=self._victim_key)
            victim = victim_res.tag
            if self._try_shrink(dev, victim, t1, t2, now):
                if victim not in shrunk:
                    shrunk.append(victim)
            else:
                self._preempt_victim(dev, victim, victim_res.amount, now)
                preempted.append(victim)
                if victim in shrunk:    # shrunk earlier, evicted after all
                    shrunk.remove(victim)
            plan = placement()          # link moved; re-derive the window
            if plan is None:
                return None, preempted, shrunk
            msg_t1, t1, t2 = plan
        return plan, preempted, shrunk

    def _evict_conflicts_plane(self, dev, plan, placement, now: float):
        """Vectorized eviction (DESIGN.md §12), decision-identical to
        `_evict_conflicts_scalar` (tests/test_preemption_plane.py):

        * conflict enumeration is ONE overlap mask over the device's
          LP-reservation mirror (stacked t1/t2 columns in reservation-dict
          insertion order) — the scalar loop's O(reservations) Python sweep
          per victim becomes an O(reservations) C-level compare;
        * victim ranking is one pass over the stacked `_victim_key` columns
          of the handful of MASKED rows — deadlines are gathered live per
          conflict (a column snapshot would go stale: callers may legally
          mutate ``task.deadline`` after reserving), and the
          ``weakest_set`` set-health column is backed by per-request good
          counters built lazily and decremented as the loop's own evictions
          transition victims out of their sets' good states;
        * refit is the incremental `_HPWindowGrid`: each eviction subtracts
          the victim's usage mass from a segment grid built once over the
          window plus its expected drift, instead of re-probing
          ``dev.fits`` (and re-flushing the skyline) per victim; the grid
          is rebuilt only if an eviction chain outruns the covered
          horizon.

        The loop assumes the only task-state/calendar mutations during the
        admission are its own (the ``on_preempt`` callback must not reserve
        on this device or flip sibling task states — none of the runtimes
        do)."""
        mir = dev.lp_mirror()
        m = mir.m
        msg_t1, t1, t2 = plan
        if m == 0:
            # no LP reservations at all -> the scalar loop's first conflict
            # sweep comes back empty and it breaks immediately
            return plan, [], []
        ct1, ct2, camt = mir.t1[:m], mir.t2[:m], mir.amount[:m]
        alive = mir.alive[:m]       # live view: release flips rows in place
        tasks = mir.tasks
        weakest = self.victim_policy == "weakest_set"
        goods: dict[int, int] = {}      # per-request good-state counters,
        sizes: dict[int, int] = {}      # built lazily per ranked candidate
        preempted: list[Task] = []
        shrunk: list[Task] = []
        # Grid horizon: the window plus the drift this loop's own preempt
        # messages can cause (each pushes the re-derived window later by at
        # most its own link slot) — covers long eviction chains without a
        # rebuild, and a chain that outruns it just rebuilds.
        drift = 64.0 * self.net.slot(self.net.msg.preempt)
        grid = _HPWindowGrid(dev, t1, t2 + drift + 0.5 * (t2 - t1),
                             ct1, ct2, alive)
        while True:
            fits = grid.fits_window(t1, t2, 1)
            if fits is None:            # drifted past coverage: rebuild
                grid = _HPWindowGrid(dev, t1, t2 + drift + 0.5 * (t2 - t1),
                                     ct1, ct2, alive)
                fits = grid.fits_window(t1, t2, 1)
            if fits:
                break
            cand = np.flatnonzero(alive & (ct1 < t2 - EPS)
                                  & (t1 < ct2 - EPS))
            if cand.size == 0:
                break
            # victim-key columns for the masked rows only; ``cand`` is
            # ascending, so a first-tie argmin lands on the lowest row
            # index — exactly min()'s tie-break over dict iteration order
            dl = np.fromiter((tasks[i].deadline for i in cand),
                             np.float64, cand.size)
            if weakest:
                health = np.fromiter(
                    (self._cand_health(tasks[i], goods, sizes)
                     for i in cand),
                    np.float64, cand.size)
                k = rank_victims(np.ones(cand.size, dtype=bool), dl, health)
            else:
                # first max deadline == min() over (-deadline,) tuples with
                # its first-tie break (np.argmax keeps the first maximum)
                k = int(np.argmax(dl))
            idx = int(cand[k])
            victim = tasks[idx]
            vt1, vt2 = float(ct1[idx]), float(ct2[idx])
            vamt = int(camt[idx])
            if self._try_shrink(dev, victim, t1, t2, now):
                # The truncate synced ct2[idx] in place (mirror row), so the
                # candidate mask stays exact — but the new endpoint need not
                # align with the grid's breakpoints, so a partial-segment
                # delta would under-free.  Rebuild instead (the established
                # exact fallback; the flushed skyline already reflects the
                # truncation) after re-deriving the drifted window.
                if victim not in shrunk:
                    shrunk.append(victim)
                plan = placement()      # link moved; re-derive the window
                if plan is None:
                    return None, preempted, shrunk
                msg_t1, t1, t2 = plan
                grid = _HPWindowGrid(dev, t1, t2 + drift + 0.5 * (t2 - t1),
                                     ct1, ct2, alive)
                continue
            was_good = victim.state in GOOD_STATES
            self._preempt_victim(dev, victim, vamt, now)   # flips alive[idx]
            preempted.append(victim)
            if victim in shrunk:        # shrunk earlier, evicted after all
                shrunk.remove(victim)
            if weakest and was_good and victim.request_id in goods:
                # the eviction moved the victim out of its set's good
                # states; its still-candidate siblings weaken accordingly
                goods[victim.request_id] -= 1
            grid.evict(vt1, vt2, vamt)
            plan = placement()          # link moved; re-derive the window
            if plan is None:
                return None, preempted, shrunk
            msg_t1, t1, t2 = plan
        return plan, preempted, shrunk

    def _cand_health(self, task: Task, goods: dict, sizes: dict) -> float:
        """`_set_health` backed by the eviction loop's incremental
        per-request counters (identical fractions: same integer numerator
        and denominator as the scalar scan)."""
        rid = task.request_id
        if rid is None:
            return 1.0
        if rid not in goods:
            req = self._requests.get(rid)
            if req is None or not req.tasks:
                return 1.0
            goods[rid] = sum(1 for t in req.tasks if t.state in GOOD_STATES)
            sizes[rid] = len(req.tasks)
        return goods[rid] / sizes[rid]

    def _reallocate_victims(self, victims: list[Task],
                            now: float) -> list[Allocation]:
        """Batch victim reallocation: every evicted LP task gets one
        placement attempt before its own deadline (success -> ALLOCATED,
        else FAILED), all sharing ONE placement context so same-type
        victims reuse the probe plane's link windows and feasibility scan
        (a commit invalidates the memo, exactly like the LP sweep — the
        decisions are identical to N independent `_allocate_lp_task`
        calls).  Runs on BOTH outcomes of the HP admission; running it on
        the failure path too is the PR 5 stranded-victim bugfix."""
        if not victims:
            return []
        reallocs: list[Allocation] = []
        ctx: dict = {}
        for victim in victims:
            r_wall = _time.perf_counter()
            re = self._allocate_lp_task(victim, now, victim.deadline, ctx)
            if re is None and self.degrade:
                # degrade-before-reject: retry down the victim's ladder
                # before settling it FAILED.  The retry commits through its
                # own context, so the shared memo must be invalidated.
                re = self._degrade_retry(victim, now, victim.deadline)
                if re is not None:
                    ctx["valid"] = False
            self.metrics.t_realloc.append(_time.perf_counter() - r_wall)
            if re is not None:
                victim.state = TaskState.ALLOCATED
                self.metrics.realloc_success += 1
                reallocs.append(re)
            else:
                victim.state = TaskState.FAILED
                self.metrics.realloc_failure += 1
        return reallocs

    def _victim_key(self, r: Reservation):
        """Smaller = preferred victim (used with min()); the shared scalar
        rule from core/victims.py over this reservation's task."""
        return victim_sort_key(r.tag, self.victim_policy, self._set_health)

    _TERMINAL = (TaskState.COMPLETED, TaskState.FAILED, TaskState.VIOLATED)

    def _prune_requests(self) -> None:
        """Drop set-health registry entries whose tasks are all terminal.

        A request only matters to ``_set_health``/``_cand_health`` while one
        of its tasks can still be a preemption candidate — i.e. holds a live
        reservation (ALLOCATED/RUNNING).  Once every task is terminal
        (COMPLETED/FAILED/VIOLATED) the entry can never be consulted again,
        so dropping it is decision-identical.  Amortised O(1): runs only
        when the registry doubled (the ``LinkSlotRegistry.prune`` pattern) —
        without this, an open-ended streaming run retains every
        LowPriorityRequest ever admitted."""
        if len(self._requests) <= self._requests_prune_at:
            return
        terminal = self._TERMINAL
        self._requests = {
            rid: req
            for rid, req in self._requests.items()
            if any(t.state not in terminal for t in req.tasks)
        }
        self._requests_prune_at = max(256, 2 * len(self._requests))

    def _set_health(self, task: Task) -> float:
        """Fraction of the task's request set still on track to complete."""
        req = (self._requests.get(task.request_id)
               if task.request_id is not None else None)
        if req is None or not req.tasks:
            return 1.0
        good = sum(1 for t in req.tasks if t.state in GOOD_STATES)
        return good / len(req.tasks)

    def _commit_hp(
        self, task: Task, msg_t1: float, msg_dur: float, t1: float, t2: float
    ) -> Allocation:
        net, link = self.net, self.state.link
        dev = self.state.devices[task.source_device]
        slots = [link.reserve(msg_t1, msg_t1 + msg_dur, ("hp_alloc", task.task_id))]
        dev.reserve(t1, t2, 1, task)
        # completion state-update sized by the task's own profile (the paper
        # profile's output_bytes IS msg.state_update, so the default world
        # is unchanged)
        upd_dur = net.slot(net.profile(task.task_type).output_bytes)
        slots.append(link.reserve_earliest(upd_dur, t2, ("update", task.task_id)))
        task.state = TaskState.ALLOCATED
        task.device, task.cores = task.source_device, 1
        task.t_start, task.t_end, task.offloaded = t1, t2, False
        self.links.record(task.task_id, slots)
        return Allocation(task, task.source_device, t1, t2, 1, False, slots)

    # ------------------------------------------------------------------ #
    # Low-priority algorithm                                             #
    # ------------------------------------------------------------------ #
    def allocate_low_priority(self, request: LowPriorityRequest, now: float) -> LPResult:
        """Admit one LP request: search the §4 time-point grid, partially
        allocating each task at its minimum viable configuration, then try to
        upgrade allocations at every time-point while tasks remain pending.

        The search order and results are the paper's exactly; the only
        scalability addition is the skip-hint pruning (see `_hint_start`),
        which elides time-points where a full device scan would *provably*
        fail and therefore cannot change the outcome."""
        t_wall = _time.perf_counter()
        self.state.gc(now)
        self.links.prune(now)
        self._prune_requests()
        self._requests[request.request_id] = request     # set-health registry
        deadline = request.deadline
        unallocated = [t for t in request.tasks if t.state == TaskState.PENDING]
        result = LPResult()

        hints: dict[int, float] = {}
        ctx: dict = {}                        # shared placement memo (§4 scan)
        # Explicit iteration so a satisfied request stops BEFORE pulling the
        # next grid point — with the lazy grid, finishing at ``now`` (the
        # common steady-state case) then never materialises the merge.
        time_points = self._time_point_grid(now, deadline)
        while unallocated:
            tp = next(time_points, None)
            if tp is None:
                break
            self.grid_rounds += 1
            round_hints: dict = {}            # per-profile, lazily per tp
            for task in list(unallocated):
                hint = hints.get(task.task_id)
                if hint is not None and \
                        self._task_t1_off(ctx, tp, task) < hint - EPS:
                    continue
                alloc = self._allocate_lp_task(task, tp, deadline, ctx)
                if alloc is not None:
                    unallocated.remove(task)
                    result.allocations.append(alloc)
                    continue
                round_hint = self._round_hint(round_hints, tp, task)
                if round_hint is not None:
                    hints[task.task_id] = round_hint
            # upgrade pass: try to give every allocated task more cores
            self._upgrade_pass(result.allocations, hints)

        for task in list(unallocated):
            # degrade-before-reject (DESIGN.md §17): the base rung failed
            # across the whole grid; retry down the ladder before FAILED.
            alloc = self._degrade_retry(task, now, deadline)
            if alloc is not None:
                unallocated.remove(task)
                result.allocations.append(alloc)
        result.failed = unallocated
        for t in unallocated:
            t.state = TaskState.FAILED
        self.metrics.t_lp_alloc.append(_time.perf_counter() - t_wall)
        return result

    def _time_point_grid(self, now: float, deadline: float):
        """The §4 search grid: ``now`` followed by the network-wide
        completion points up to the deadline — lazily (requests usually
        allocate within the first few points, so the rest of the merge
        never runs).  Exact duplicates are skipped: a repeated time-point
        re-derives the identical link windows and placement answers, so
        dropping it provably cannot change a decision (the counter and the
        identical-decision proof live in tests/test_grid_dedup.py)."""
        grid = itertools.chain([now],
                               self.state.iter_completion_times(now, deadline))
        return self._dedup(grid) if self._dedup_grid else grid

    def _dedup(self, grid):
        last = None
        for tp in grid:
            if last is not None and tp == last:
                self.grid_dups_skipped += 1
                continue
            last = tp
            yield tp

    def _refresh_ctx(self, ctx: dict, tp: float) -> dict:
        """(Re)derive the link-dependent placement windows for time-point
        ``tp``: the allocation-message slot and the resulting ``arrival``.
        These are identical for every task probed at the same time-point
        while nothing commits, so they are memoised in ``ctx`` (a commit
        invalidates it).  Profile-dependent windows — the input transfer and
        the offloaded execution start — live in per-profile sub-memos
        (``_profile_ctx``).  Probing does not mutate the link."""
        if ctx.get("valid") and ctx.get("tp") == tp:
            return ctx
        net, link = self.net, self.state.link
        msg_dur = net.slot(net.msg.lp_alloc)
        msg_t1 = link.earliest_slot(msg_dur, tp)
        arrival = msg_t1 + msg_dur
        ctx.clear()
        ctx.update(tp=tp, valid=True, msg_t1=msg_t1, msg_dur=msg_dur,
                   arrival=arrival, prof={})
        return ctx

    def _profile_ctx(self, ctx: dict, prof) -> dict:
        """Per-profile slice of the placement memo: the input-transfer slot
        (sized by the profile's ``input_bytes``), the offloaded execution
        start ``t1_off``, and the network-wide offload feasibility scan
        (which depends on the profile's min-config duration).  Tasks of the
        same type probed at the same time-point share all of it."""
        sub = ctx["prof"].get(prof.name)
        if sub is None:
            link = self.state.link
            xfer_dur = self.net.slot(prof.input_bytes)
            xfer_t1 = link.earliest_slot(xfer_dur, ctx["arrival"])
            sub = ctx["prof"][prof.name] = dict(
                xfer_dur=xfer_dur, xfer_t1=xfer_t1,
                t1_off=xfer_t1 + xfer_dur, feasible=None)
        return sub

    def _window_loads(self, ctx: dict, arrival: float,
                      deadline: float) -> np.ndarray:
        """Stacked per-device loads over [arrival, deadline) from the probe
        plane, memoised in the placement context: within one time-point
        nothing mutates between commits, so every candidate scan sharing the
        window (same request deadline) reuses one vectorized pass."""
        memo = ctx.setdefault("loads", {})
        loads = memo.get(deadline)
        if loads is None:
            loads = memo[deadline] = \
                self.state.probe_plane().loads(arrival, deadline)
        return loads

    def _task_t1_off(self, ctx: dict, tp: float, task: Task) -> float:
        """The offloaded execution start a task would see at ``tp``."""
        prof = self.net.profile_for(task)
        return self._profile_ctx(self._refresh_ctx(ctx, tp), prof)["t1_off"]

    def _round_hint(self, round_hints: dict, tp: float,
                    task: Task) -> Optional[float]:
        """`_hint_start` for the task's profile, computed lazily once per
        (time-point, profile) — every same-type task failing a full scan at
        the same time-point shares the bound.  Profiles resolve through the
        task's ladder rung (``profile_for``); variant profiles carry
        distinct names, so rungs memoise separately."""
        prof = self.net.profile_for(task)
        if prof.name not in round_hints:
            round_hints[prof.name] = self._hint_start(tp, prof)
        return round_hints[prof.name]

    def _hint_start(self, tp: float, prof) -> Optional[float]:
        """Earliest instant ANY device could start a minimum-config LP task
        of profile ``prof``, given occupancy as of now.  It is
        task-independent (within a task type) and a valid lower bound until
        occupancy *shrinks* (reservations only ever get added during a
        request sweep; core upgrades are the one shrinking case and
        `_upgrade_pass` scopes the invalidation).

        A time-point can then be skipped for a hinted task when BOTH of its
        candidate execution starts — local ``arrival`` and offloaded
        ``t1_off`` — lie below the bound (``t1_off >= arrival``, so checking
        ``t1_off`` suffices).  The comparison must use the *actual*
        link-derived windows of that time-point (`_task_t1_off`), never
        ``tp`` itself: link congestion can push the windows far past ``tp``,
        to where a device has already freed up.  Returns None when the
        calendars don't support skyline queries (reference implementation)."""
        devices = self.state.devices
        if not devices or not hasattr(devices[0], "earliest_fit"):
            return None
        cores_min = prof.core_options[0]
        proc_min = prof.lp_slot_time(cores_min)
        if self._plane_ok:
            # One vectorized first-fit pass over every device (bit-identical
            # to the per-device scalar min below).
            plane = self.state.probe_plane()
            return float(plane.earliest_fit(proc_min, tp, cores_min).min())
        return min(d.earliest_fit(proc_min, tp, cores_min) for d in devices)

    def _upgrade_pass(self, allocations, hints: dict[int, float]) -> list[float]:
        """Raise core configs where possible, then drop the skip hints a
        successful upgrade may have invalidated: an upgrade only *frees*
        capacity in the tail [t_end_new, t_end_old) of its slot, so any
        newly feasible min-config window must overlap that tail, i.e. start
        after ``t_end_new - proc_min``.  Hints at or below that threshold
        remain valid lower bounds regardless of device capacity (with
        capacity 4 the early part of an upgraded slot is saturated anyway;
        with larger capacities it need not be, hence the proc_min margin).

        Returns the upgraded allocations' new completion times so the batch
        sweep can keep its time-point grid in sync (an upgrade moves a
        completion point earlier; the stale point is already in the grid).

        ``proc_min`` is the workload-wide minimum min-config slot duration:
        with heterogeneous profiles a freed tail might admit the *fastest*
        task type, so the threshold must use its duration (for the paper's
        single-profile spec this is exactly the old global constant)."""
        proc_min = self.net.spec.min_lp_slot_time
        new_ends: list[float] = []
        for alloc in allocations:
            if self._try_upgrade(alloc):
                new_ends.append(alloc.t_end)
        if new_ends and hints:
            thresh = min(new_ends) - proc_min
            for tid in [t for t, h in hints.items() if h > thresh + EPS]:
                del hints[tid]
        return new_ends

    def allocate_low_priority_batch(
        self, requests: Sequence[LowPriorityRequest], now: float
    ) -> list[LPResult]:
        """Admit a burst of LP requests in ONE gc + ONE time-point sweep.

        The sequential path (`allocate_low_priority`) re-derives the
        network-wide completion-time grid and re-runs the sweep for every
        request; under a large arrival burst that is O(requests x grid).
        This method instead:

        * garbage-collects once,
        * pools every pending task, ordered earliest-deadline-first across
          the whole batch (deterministic tie-break: submission order),
        * walks one monotone time-point heap seeded with the current
          network-wide completion times and fed with the completion points
          of allocations made *by this batch*, so later tasks immediately
          see slots freed/created by earlier ones,
        * prunes a task permanently once the sweep passes its request
          deadline (it can never allocate at a later point), and
        * runs the core-upgrade pass per time-point for the requests that
          progressed there (the batch analogue of the §4 upgrade sweep).

        Results are returned positionally (one LPResult per input request).
        Per-task placement rules (minimum config, even spreading, upgrade
        pass) are the sequential path's; the *search* deliberately differs
        in two ways, so a batch is NOT guaranteed to reproduce sequential
        admissions call-for-call: requests are interleaved
        earliest-deadline-first rather than in caller order (the fairer
        policy at scale), and the grid absorbs completion points created by
        the batch itself, which the sequential path's snapshot grid never
        revisits.  Per-request latency metrics are recorded as the batch's
        amortised share so Fig-9/10 style summaries stay comparable.
        """
        t_wall = _time.perf_counter()
        self.state.gc(now)
        self.links.prune(now)
        self._prune_requests()
        results = [LPResult() for _ in requests]
        order = itertools.count()
        pending: list[tuple[float, int, int, Task]] = []
        for ridx, req in enumerate(requests):
            self._requests[req.request_id] = req         # set-health registry
            for task in req.tasks:
                if task.state == TaskState.PENDING:
                    pending.append((req.deadline, next(order), ridx, task))
        if pending:
            pending.sort()
            max_dl = max(req.deadline for req in requests)
            # The network-wide grid, merged in one vectorized pass; a sorted
            # unique list is already a valid min-heap, so no heapify.  The
            # ``in_grid`` set keeps the heap duplicate-free: batch-created
            # completion points (allocations, upgrades) that coincide with a
            # point already in the grid would only pop into the existing
            # ``cand <= tp`` skip, so dropping them at push time is provably
            # decision-neutral (tests/test_grid_dedup.py).
            tp_heap = self.state.completion_times(now, max_dl)
            self.grid_pushes += len(tp_heap)
            in_grid = set(tp_heap) if self._dedup_grid else None
            tp = now
            # Skip hints (see `_hint_start`): a task that failed a full scan
            # is skipped in O(1) at every time-point whose actual execution
            # windows lie provably below the earliest instant any device
            # could start it; a successful core-upgrade shrinks a
            # reservation, so it prunes the invalidated hints.
            hints: dict[int, float] = {}
            ctx: dict = {}                    # shared placement memo (§4 scan)
            def push_tp(t_end: float) -> None:
                """Feed a batch-created completion point into the grid,
                skipping exact duplicates of points already queued."""
                if not (tp + EPS < t_end < max_dl - EPS):
                    return
                if in_grid is not None:
                    if t_end in in_grid:
                        self.grid_dups_skipped += 1
                        return
                    in_grid.add(t_end)
                self.grid_pushes += 1
                heapq.heappush(tp_heap, t_end)

            while pending:
                self.grid_rounds += 1
                still: list[tuple[float, int, int, Task]] = []
                progressed: set[int] = set()
                round_hints: dict = {}        # per-profile, lazily per tp
                for item in pending:
                    deadline, _, ridx, task = item
                    if deadline <= tp + EPS:
                        # the sweep passed the request deadline at the base
                        # rung; degrade-before-reject gets one ladder retry
                        # over the original window before FAILED settles
                        alloc = self._degrade_retry(task, now, deadline)
                        if alloc is not None:
                            ctx["valid"] = False    # retry committed
                            round_hints.clear()     # occupancy grew
                            results[ridx].allocations.append(alloc)
                            progressed.add(ridx)
                            push_tp(alloc.t_end)
                        else:
                            task.state = TaskState.FAILED
                            results[ridx].failed.append(task)
                        continue
                    hint = hints.get(task.task_id)
                    if hint is not None and \
                            self._task_t1_off(ctx, tp, task) < hint - EPS:
                        still.append(item)
                        continue
                    alloc = self._allocate_lp_task(task, tp, deadline, ctx)
                    if alloc is None:
                        round_hint = self._round_hint(round_hints, tp, task)
                        if round_hint is not None:
                            hints[task.task_id] = round_hint
                        still.append(item)
                        continue
                    round_hints.clear()       # occupancy grew; recompute
                    results[ridx].allocations.append(alloc)
                    progressed.add(ridx)
                    push_tp(alloc.t_end)
                # Sorted: upgrades shrink reservations, so cross-request
                # upgrade order can change what later upgrades see — pin
                # it to ascending request index instead of set order
                # (which only coincides with it for small ints).
                for ridx in sorted(progressed):
                    for t_end in self._upgrade_pass(results[ridx].allocations,
                                                    hints):
                        # the upgrade moved this completion point earlier;
                        # the grid must contain the new one too
                        push_tp(t_end)
                pending = still
                if not pending:
                    break
                # Earliest instant any still-pending task could possibly
                # start (after the upgrade pass pruned stale hints): a grid
                # point whose actual execution windows lie below it is
                # provably useless for EVERY pending task, so skip whole
                # rounds, not just tasks.  As in the per-task skip, the
                # comparison needs the candidate's link-derived windows,
                # not the raw grid time — and with heterogeneous profiles
                # the LATEST execution start any pending type would see
                # (the largest input transfer), so the skip stays a safe
                # over-approximation for every profile at once.
                floor_hint: Optional[float] = None
                for item in pending:
                    h = hints.get(item[3].task_id)
                    if h is None:
                        floor_hint = None
                        break
                    if floor_hint is None or h < floor_hint:
                        floor_hint = h
                worst_prof = self.net.profile(
                    self.net.spec.max_input_bytes_type)
                nxt = None
                while tp_heap:
                    cand = heapq.heappop(tp_heap)
                    if cand <= tp + EPS:
                        continue
                    if floor_hint is not None and \
                            self._profile_ctx(self._refresh_ctx(ctx, cand),
                                              worst_prof)["t1_off"] < \
                            floor_hint - EPS:
                        continue
                    nxt = cand
                    break
                if nxt is None:
                    break
                tp = nxt
            for d, _, ridx, task in pending:      # deadline passed mid-sweep
                alloc = self._degrade_retry(task, now, d)
                if alloc is not None:
                    results[ridx].allocations.append(alloc)
                    continue
                task.state = TaskState.FAILED
                results[ridx].failed.append(task)
        share = (_time.perf_counter() - t_wall) / max(len(requests), 1)
        self.metrics.t_lp_alloc.extend([share] * len(requests))
        return results

    def reallocate(self, task: Task, now: float) -> Optional[Allocation]:
        """Public reallocation entry (used by runtimes on external preemption).

        The task's previous allocation is torn down first — its device
        reservation is released and its still-pending link slots
        (xfer/update) are cancelled — whether or not the reallocation
        succeeds: the old slots describe work and traffic that will never
        happen (same hygiene the preemption loop applies to its victims).
        """
        r_wall = _time.perf_counter()
        if task.device is not None:
            self.state.devices[task.device].release(task)
        self.links.cancel_pending(self.state.link, task.task_id, now)
        alloc = self._allocate_lp_task(task, now, task.deadline)
        if alloc is None:
            alloc = self._degrade_retry(task, now, task.deadline)
        self.metrics.t_realloc.append(_time.perf_counter() - r_wall)
        if alloc is not None:
            task.state = TaskState.ALLOCATED
            self.metrics.realloc_success += 1
        else:
            task.state = TaskState.FAILED
            self.metrics.realloc_failure += 1
        return alloc

    # ------------------------------------------------------------------ #
    # Device churn (DESIGN.md §16)                                       #
    # ------------------------------------------------------------------ #
    def fail_device(self, idx: int, now: float) -> tuple[list[Task],
                                                         list[Allocation]]:
        """Hard-fail a device: orphan its in-flight tasks and drive recovery.

        Every orphan's still-pending link slots are cancelled exactly like
        preemption's slot cleanup; LP orphans then go through the batch
        victim-reallocation pass (one shared placement context — the PR 5
        plane), so each terminates ALLOCATED-elsewhere-before-deadline or
        FAILED.  HP orphans come back PREEMPTED for immediate re-admission
        — the dispatcher's ``device_lost`` (or ``settle_hp_orphans`` on
        scheduler-direct drivers) settles them.  Returns
        ``(orphans, lp_reallocations)``.
        """
        self.state.gc(now)
        self.links.prune(now)
        orphans = self.state.fail_device(idx, now)
        link = self.state.link
        lp_orphans: list[Task] = []
        for task in orphans:
            self.links.cancel_pending(link, task.task_id, now)
            task.state = TaskState.PREEMPTED    # transient, like an eviction
            if task.priority == Priority.LOW:
                lp_orphans.append(task)
        self.metrics.device_failures += 1
        self.metrics.orphans_created += len(orphans)
        reallocs = self._reallocate_victims(lp_orphans, now)
        self.metrics.orphans_recovered += len(reallocs)
        return orphans, reallocs

    def settle_hp_orphans(self, orphans: Sequence[Task],
                          now: float) -> list[HPResult]:
        """Re-admit HP orphans immediately — ahead of the next admission
        window.  HP execution is source-local (paper rule), so an orphan
        whose home device stays DOWN settles FAILED (``hp_failed_alloc``);
        an orphan is never left stranded in PREEMPTED."""
        results: list[HPResult] = []
        for task in orphans:
            if task.priority != Priority.HIGH:
                continue
            res = self.allocate_high_priority(task, now)
            if res.success:
                self.metrics.orphans_recovered += 1
            else:
                task.state = TaskState.FAILED
                self.metrics.hp_failed_alloc += 1
                self.metrics.count_type(task.task_type, "hp_failed_alloc")
            results.append(res)
        return results

    def drain_device(self, idx: int, now: float) -> None:
        """Graceful drain: in-flight reservations finish, no new placements
        (the probe plane's alive mask excludes the device immediately)."""
        self.state.drain_device(idx)
        self.metrics.device_drains += 1

    def rejoin_device(self, idx: int, now: float) -> None:
        """Bring a drained or failed device back into the placement pool."""
        self.state.rejoin_device(idx)
        self.metrics.device_rejoins += 1

    def _degrade_retry(self, task: Task, now: float,
                       deadline: float) -> Optional[Allocation]:
        """Degrade-before-reject (DESIGN.md §17): one ladder walk for an
        otherwise-failed LP task.

        Runs only at SETTLE time — after the base-rung search exhausted the
        whole time-point grid — never per time-point, so a task is only
        degraded when its current rung provably cannot be placed anywhere
        in its window (accuracy is sacrificed last, not first).  Each
        deeper rung re-walks the §4 grid through the normal placement path
        (`_allocate_lp_task` resolves the rung's profile; variant profiles
        carry distinct names, so the probe memos stay sound).  On success
        the task keeps the admitted rung in ``task.variant`` and counts
        ``lp_degraded``; on failure the original rung is restored and the
        caller settles FAILED (this helper assigns no terminal state).
        """
        if not self.degrade or task.priority is not Priority.LOW:
            return None
        base = self.net.profile(task.task_type)
        original = task.variant
        for rung in range(original + 1, base.n_variants):
            task.variant = rung
            ctx: dict = {}
            for tp in self._time_point_grid(now, deadline):
                alloc = self._allocate_lp_task(task, tp, deadline, ctx)
                if alloc is not None:
                    self.metrics.lp_degraded += 1
                    return alloc
        task.variant = original
        return None

    def _allocate_lp_task(
        self, task: Task, tp: float, deadline: float,
        ctx: Optional[dict] = None,
    ) -> Optional[Allocation]:
        """Partial allocation of one task at the minimum viable config (§4).

        Placement policy (identical outcome to the paper's load-sorted scan,
        restructured for scale):

        * source device first (no input transfer), else the least-loaded
          device among those that *fit* — feasibility is checked before
          computing loads, because ``fits`` is an early-exit skyline probe
          while ``load`` integrates the whole deadline window, and in a
          saturated network most devices fail the cheap check;
        * ``ctx`` (same dict passed across calls of one sweep) memoises the
          link-derived windows and the network-wide offload feasibility
          scan, which are identical for every task probed at the same
          time-point — nothing mutates between two commits, so when a burst
          of pending tasks wakes at a freed slot, only the first pays the
          O(devices) scan.  A commit invalidates the context.
        """
        net, link = self.net, self.state.link
        prof = net.profile_for(task)            # the task's ladder rung
        cores = prof.core_options[0]            # minimum viable config
        proc = prof.lp_slot_time(cores)
        if ctx is None:
            ctx = {}
        self._refresh_ctx(ctx, tp)
        self.lp_probes += 1
        msg_t1, msg_dur = ctx["msg_t1"], ctx["msg_dur"]
        arrival = ctx["arrival"]
        if arrival + proc > deadline:
            return None

        source = task.source_device
        sdev = self.state.devices[source]
        if _dev_up(sdev) and sdev.fits(arrival, arrival + proc, cores):
            dev, offloaded, xfer_t1, xfer_dur, t1 = sdev, False, 0.0, 0.0, arrival
        elif not self.allow_offload:
            return None
        else:
            sub = self._profile_ctx(ctx, prof)
            xfer_t1, xfer_dur = sub["xfer_t1"], sub["xfer_dur"]
            t1 = sub["t1_off"]
            if t1 + proc > deadline:
                return None
            if sub["feasible"] is None:
                # All offloaded candidates of one task type share the same
                # transfer slot, hence the same execution window and
                # feasibility scan — one vectorized fits-mask over every
                # device (per-device scalar loop only for the reference
                # calendars, which predate the probe plane).
                if self._plane_ok:
                    plane = self.state.probe_plane()
                    sub["feasible"] = np.flatnonzero(
                        plane.fits_mask(t1, t1 + proc, cores))
                else:
                    sub["feasible"] = [d.device for d in self.state.devices
                                       if _dev_up(d)
                                       and d.fits(t1, t1 + proc, cores)]
            # even spreading: least load over the deadline window; argmin
            # over the stacked load vector returns the FIRST minimum, i.e.
            # ties break toward the lowest device index — exactly the old
            # (load, d.device) key.
            if self._plane_ok:
                feas = sub["feasible"]
                cands = feas[feas != source]
                if cands.size == 0:
                    return None
                loads = self._window_loads(ctx, arrival, deadline)
                dev = self.state.devices[int(cands[np.argmin(loads[cands])])]
            else:
                cands = [self.state.devices[i] for i in sub["feasible"]
                         if i != source]
                if not cands:
                    return None
                dev = min(cands,
                          key=lambda d: (d.load(arrival, deadline), d.device))
            offloaded = True

        # commit (mutates the link and a device calendar -> context dies)
        ctx["valid"] = False
        t2 = t1 + proc
        slots = [link.reserve(msg_t1, msg_t1 + msg_dur, ("lp_alloc", task.task_id))]
        if offloaded:
            slots.append(
                link.reserve(xfer_t1, xfer_t1 + xfer_dur, ("xfer", task.task_id))
            )
        dev.reserve(t1, t2, cores, task)
        upd_dur = net.slot(prof.output_bytes)
        slots.append(link.reserve_earliest(upd_dur, t2, ("update", task.task_id)))
        task.state = TaskState.ALLOCATED
        task.device, task.cores = dev.device, cores
        task.t_start, task.t_end, task.offloaded = t1, t2, offloaded
        self.links.record(task.task_id, slots)
        return Allocation(task, dev.device, t1, t2, cores, offloaded, slots)

    def _try_upgrade(self, alloc: Allocation) -> bool:
        """Improve an allocation by raising its core configuration (§4).

        Feasibility is probed with the task's own slot still in place: the
        slot spans the whole candidate window (more cores = shorter slot)
        and contributes exactly ``alloc.cores`` everywhere in it, so asking
        for ``cores - alloc.cores`` MORE cores is bit-identical to the
        release-then-probe formulation — without paying two calendar
        mutations per failed attempt."""
        if alloc.task.degraded:
            # load-shedding degrade mode (serving/stream.py): the task is
            # pinned to its minimum core configuration under overload
            return False
        prof = self.net.profile(alloc.task.task_type)
        options = [c for c in prof.core_options if c > alloc.cores]
        if not options:
            return False
        dev = self.state.devices[alloc.device]
        res = dev.get(alloc.task)
        if res is None:
            return False
        for cores in reversed(options):          # largest improvement first
            t2 = alloc.t_start + prof.lp_slot_time(cores)
            if t2 <= alloc.task.deadline and \
                    dev.fits(alloc.t_start, t2, cores - res.amount):
                dev.reserve(alloc.t_start, t2, cores, alloc.task)
                alloc.cores, alloc.t_end = cores, t2
                alloc.task.cores, alloc.task.t_end = cores, t2
                return True
        return False
