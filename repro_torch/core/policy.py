"""Unified SchedulingPolicy API: one decision protocol + policy registry.

Every scheduling discipline the repo evaluates — the paper's
preemption-aware scheduler, the two workstealer baselines, and any future
discipline — implements the same small protocol and registers itself by
name, so the discrete-event simulation (``sim/experiment.py``) and the jax
serving engine (``serving/engine.py``) can drive *any* policy through one
shared admission/execution/completion loop (``PolicyDispatcher``) instead
of bespoke per-discipline code paths.

The protocol (DESIGN.md §9)
---------------------------
A policy answers admission questions with a :class:`Decision`:

* ``decide_hp(task, now)``            one high-priority task
* ``decide_lp(request, now)``         one low-priority request set
* ``decide_lp_batch(requests, now)``  a burst of LP requests (positional
                                      results; default: per-request loop)
* ``reallocate(task, now)``           re-place an externally preempted task

and is told about execution outcomes through structured events:

* ``on_preempt(task, now)``   the runtime stopped a running task
* ``on_complete(task, now)``  a task finished inside its reserved slot
* ``on_violate(task, now)``   a task overran its slot and was terminated
* ``finalize(now)``           end of run (drain queues, settle accounting)

Two execution styles coexist behind the protocol:

* **slot-based** (``drives_execution = False``): decisions carry
  ``Allocation`` records with reserved ``[t_start, t_end)`` windows and the
  dispatcher runs execution — either *simulated* (noisy runtimes, slot
  violations; the sim) or *exact-slot* (real compute fills the reserved
  slot; the serving engine).
* **policy-driven** (``drives_execution = True``): the policy owns its own
  execution model (the workstealers' processor sharing) and reports
  outcomes back through the dispatcher's accounting hooks
  (``lp_started`` / ``task_finished``), so metrics stay uniform across
  disciplines.

Registry
--------
``@register_policy("name")`` on a policy class makes it constructible via
``create_policy(name, n_devices=..., net=..., ...)``; ``ScenarioConfig``
and the serving engine resolve their ``algorithm`` / ``policy`` strings
through it, so a new discipline is a ~100-line plugin with zero edits to
the runtimes (see ``EDFOnlyPolicy`` below).
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from .calendar import NetworkState
from .metrics import Metrics
from .network import NetworkConfig
from .scheduler import (
    Allocation,
    HPResult,
    LinkSlotRegistry,
    LPResult,
    PreemptionAwareScheduler,
)
from .task import LowPriorityRequest, Priority, Task, TaskState


# ====================================================================== #
# Decision                                                               #
# ====================================================================== #
class DecisionStatus(enum.Enum):
    ADMITTED = "admitted"    # resources committed (possibly partially)
    DEFERRED = "deferred"    # queued; the policy will place the work later
    REJECTED = "rejected"    # nothing could be (or will be) placed


@dataclass
class Decision:
    """The unified outcome of any admission question.

    ``allocations`` carry committed placements (slot-based policies);
    ``failed`` the tasks that could not be placed; ``preempted`` the
    victims this decision evicted (the runtime must stop them);
    ``reallocations`` the victims' replacement slots.
    ``predicted_completion`` is the latest committed slot end, when known.
    """

    status: DecisionStatus
    allocations: list[Allocation] = field(default_factory=list)
    failed: list[Task] = field(default_factory=list)
    preempted: list[Task] = field(default_factory=list)
    reallocations: list[Allocation] = field(default_factory=list)
    predicted_completion: Optional[float] = None

    @property
    def admitted(self) -> bool:
        return self.status is DecisionStatus.ADMITTED

    @property
    def deferred(self) -> bool:
        return self.status is DecisionStatus.DEFERRED

    @property
    def rejected(self) -> bool:
        return self.status is DecisionStatus.REJECTED

    # -- compatibility shims over the scheduler's historic result types -- #
    @classmethod
    def from_hp_result(cls, res: HPResult) -> "Decision":
        return cls(
            status=DecisionStatus.ADMITTED if res.success
            else DecisionStatus.REJECTED,
            allocations=[res.allocation] if res.allocation is not None else [],
            preempted=list(res.preempted),
            reallocations=list(res.reallocations),
            predicted_completion=res.allocation.t_end
            if res.allocation is not None else None,
        )

    @classmethod
    def from_lp_result(cls, res: LPResult) -> "Decision":
        return cls(
            status=DecisionStatus.ADMITTED if res.allocations
            else DecisionStatus.REJECTED,
            allocations=list(res.allocations),
            failed=list(res.failed),
            predicted_completion=max((a.t_end for a in res.allocations),
                                     default=None),
        )


# ====================================================================== #
# Protocol                                                               #
# ====================================================================== #
class SchedulingPolicy:
    """Base class / protocol every scheduling discipline implements."""

    #: registry name (set by @register_policy)
    name: str = "?"
    #: True when the policy runs its own execution model (e.g. processor
    #: sharing) through the dispatcher's accounting hooks; False when the
    #: dispatcher executes the policy's reserved slots.
    drives_execution: bool = False

    def bind(self, host: "PolicyDispatcher") -> None:
        """Attach the runtime host (event queue, rng, metrics, accounting)."""
        self.host = host

    # -- decisions ----------------------------------------------------- #
    def decide_hp(self, task: Task, now: float) -> Decision:
        raise NotImplementedError

    def decide_lp(self, request: LowPriorityRequest, now: float) -> Decision:
        raise NotImplementedError

    def decide_lp_batch(
        self, requests: Sequence[LowPriorityRequest], now: float
    ) -> list[Decision]:
        return [self.decide_lp(r, now) for r in requests]

    def reallocate(self, task: Task, now: float) -> Decision:
        return Decision(DecisionStatus.REJECTED, failed=[task])

    # -- device churn (DESIGN.md §16) ----------------------------------- #
    def fail_device(self, idx: int, now: float) -> Decision:
        """Hard-fail device ``idx``; the returned Decision carries every
        orphaned task in ``preempted``, recovered LP orphans' replacement
        slots in ``reallocations``, and unrecoverable LP orphans in
        ``failed``.  Default: no-op — policies without a shared calendar
        view (the workstealing baselines own plain worker objects) have no
        device lifecycle, so churn cannot orphan their tasks."""
        return Decision(DecisionStatus.ADMITTED)

    def drain_device(self, idx: int, now: float) -> None:
        """Stop placing new work on device ``idx`` (no-op by default)."""

    def rejoin_device(self, idx: int, now: float) -> None:
        """Return device ``idx`` to the placement pool (no-op by default)."""

    # -- structured outcome events ------------------------------------- #
    def on_preempt(self, task: Task, now: float) -> None:
        """The runtime externally stopped ``task`` (before ``reallocate``)."""

    def on_complete(self, task: Task, now: float) -> None:
        """``task`` finished executing at ``now`` (release residual slot)."""

    def on_violate(self, task: Task, now: float) -> None:
        """``task`` overran its reserved slot and was terminated (§7.3)."""

    def finalize(self, now: float) -> None:
        """End of run: drain queues, settle outstanding accounting."""

    # -- execution support (slot-based policies) ------------------------ #
    def busy_fraction(self, alloc: Allocation) -> float:
        """Contending-core fraction over the slot (drives the sim's
        contention model); 0.0 when the policy has no occupancy view."""
        return 0.0


# ====================================================================== #
# Registry                                                               #
# ====================================================================== #
_REGISTRY: dict[str, Callable[..., SchedulingPolicy]] = {}


def register_policy(name: str):
    """Class decorator: make a policy constructible by name."""

    def deco(factory):
        if name in _REGISTRY:
            raise ValueError(f"policy {name!r} already registered")
        _REGISTRY[name] = factory
        factory.name = name
        return factory

    return deco


def registered_policies() -> tuple[str, ...]:
    """Sorted names of every registered policy."""
    return tuple(sorted(_REGISTRY))


def create_policy(name: str, **kwargs) -> SchedulingPolicy:
    """Instantiate a registered policy; unknown names list the options."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; registered policies: "
            + ", ".join(registered_policies())
        ) from None
    return factory(**kwargs)


# ====================================================================== #
# Dispatcher: the one shared admission/execution/completion loop         #
# ====================================================================== #
class DispatchClient:
    """Runtime-specific hooks; every method is an optional no-op default."""

    def exec_time(self, task: Task, busy_frac: float) -> float:
        """Actual (noisy) execution time in simulated mode."""
        raise NotImplementedError

    def on_start(self, task: Task) -> None:
        """Exact-slot mode: the slot began — run the real compute."""

    def on_hp_complete(self, task: Task) -> None:
        """An HP task completed in time (sim: spawn the frame's LP set)."""

    def on_lp_complete(self, task: Task) -> None:
        """An LP task completed in time."""

    def on_preempt(self, task: Task) -> None:
        """A decision evicted ``task`` (client-side victim bookkeeping)."""

    def on_admit_fail(self, task: Task) -> None:
        """A task was rejected at admission (or failed during one)."""

    def on_late(self, task: Task) -> None:
        """A task reached a terminal state past its deadline (late
        completion or slot violation) — the failure-side counterpart of the
        ``on_*_complete`` hooks, so open-ended runtimes can settle their
        per-request bookkeeping without a final sweep."""

    def on_device_lost(self, task: Task) -> None:
        """A device failure orphaned ``task``.  Fires before recovery is
        attempted: the task may still be re-placed elsewhere, re-admitted
        (HP), or settled FAILED — terminal bookkeeping arrives through the
        usual completion/failure hooks afterwards."""


class PolicyDispatcher:
    """Drives any registered policy over an event queue: admission calls,
    Decision processing, slot execution, and uniform metric accounting.

    Collapses what used to be three near-identical loops
    (``SchedulerBackend``, ``WorkstealerBackend`` accounting, and
    ``PreemptiveServingEngine``'s admit/settle/complete) into one.
    """

    def __init__(
        self,
        policy: SchedulingPolicy,
        q,                              # sim.events.EventQueue (duck-typed)
        net: NetworkConfig,
        metrics: Metrics,
        client: Optional[DispatchClient] = None,
        *,
        lp_batch_window: float = 0.0,
        exact_slots: bool = False,
        rng=None,
        exec_noise: bool = False,
        hp_noise_sigma: float = 0.0,
        lp_noise_sigma: float = 0.0,
    ) -> None:
        self.policy = policy
        self.q = q
        self.net = net
        self.metrics = metrics
        self.client = client if client is not None else DispatchClient()
        self.lp_batch_window = lp_batch_window
        self.exact_slots = exact_slots
        # Host-provided randomness/noise for execution-driving policies.
        self.rng = rng
        self.exec_noise = exec_noise
        self.hp_noise_sigma = hp_noise_sigma
        self.lp_noise_sigma = lp_noise_sigma
        self._exec_events: dict[Task, object] = {}
        self._via_preemption: set[Task] = set()
        self._lp_buffer: list[LowPriorityRequest] = []
        self._lp_flush_armed = False
        policy.bind(self)

    @property
    def now(self) -> float:
        return self.q.now

    # ------------------------------------------------------------------ #
    # Admission                                                          #
    # ------------------------------------------------------------------ #
    def submit_hp(self, task: Task) -> Decision:
        dec = self.policy.decide_hp(task, self.q.now)
        # Victims must be stopped whether or not the admission succeeded
        # (a failed HP admission may already have evicted LP tasks).
        self._apply_preemptions(dec)
        if dec.rejected:
            task.state = TaskState.FAILED
            self.metrics.hp_failed_alloc += 1
            self.metrics.count_type(task.task_type, "hp_failed_alloc")
            self.client.on_admit_fail(task)
        else:
            if dec.preempted:
                self._via_preemption.add(task)
            for alloc in dec.allocations:
                self._schedule_exec(alloc)
        # victims a policy re-placed must run even when the admission itself
        # failed (their replacement slots are already committed)
        for re in dec.reallocations:
            self._schedule_exec(re)
        return dec

    def submit_lp(self, request: LowPriorityRequest) -> Optional[Decision]:
        """Admit one LP request; with ``lp_batch_window > 0`` the request is
        buffered and admitted by the window's flush (returns None)."""
        if self.lp_batch_window <= 0.0:
            dec = self.policy.decide_lp(request, self.q.now)
            self._account_lp(dec)
            return dec
        self._lp_buffer.append(request)
        if not self._lp_flush_armed:
            self._lp_flush_armed = True
            self.q.push(self.q.now + self.lp_batch_window, self._flush_lp_batch)
        return None

    def submit_lp_batch(self, requests: Sequence[LowPriorityRequest]) -> list[Decision]:
        decs = self.policy.decide_lp_batch(requests, self.q.now)
        for dec in decs:
            self._account_lp(dec)
        return decs

    def _flush_lp_batch(self) -> None:
        self._lp_flush_armed = False
        batch, self._lp_buffer = self._lp_buffer, []
        if batch:
            self.submit_lp_batch(batch)

    def _apply_preemptions(self, dec: Decision) -> None:
        for victim in dec.preempted:
            ev = self._exec_events.pop(victim, None)
            if ev is not None:
                ev.cancel()
            self.client.on_preempt(victim)

    def _account_lp(self, dec: Decision) -> None:
        self.metrics.lp_failed_alloc += len(dec.failed)
        for task in dec.failed:
            task.state = TaskState.FAILED
            self.metrics.count_type(task.task_type, "lp_failed_alloc")
            self.client.on_admit_fail(task)
        for alloc in dec.allocations:
            self.lp_started(alloc.task, alloc.cores, alloc.offloaded)
            self._schedule_exec(alloc)

    # ------------------------------------------------------------------ #
    # Reallocation (external preemption -> new Decision)                 #
    # ------------------------------------------------------------------ #
    def reallocate(self, task: Task) -> Decision:
        """Stop + re-place a running task through the policy, arming the
        replacement slot when one is found."""
        ev = self._exec_events.pop(task, None)
        if ev is not None:
            ev.cancel()
        self.policy.on_preempt(task, self.q.now)
        dec = self.policy.reallocate(task, self.q.now)
        for alloc in dec.allocations:
            self._schedule_exec(alloc)
        for failed in dec.failed:
            self.client.on_admit_fail(failed)
        return dec

    # ------------------------------------------------------------------ #
    # Device churn (lifecycle events -> policy + client plumbing)        #
    # ------------------------------------------------------------------ #
    def device_lost(self, idx: int) -> Decision:
        """A device vanished: orphan its in-flight tasks and drive recovery.

        The policy's ``fail_device`` clears the calendar, cancels the
        orphans' pending link slots, and settles LP orphans through its
        reallocation path (ALLOCATED elsewhere or FAILED).  Here the
        orphans' pending exec events are cancelled (they describe compute
        on hardware that no longer exists), the client is notified per
        orphan, recovered slots are armed, and HP orphans are re-admitted
        immediately — ahead of the next admission window; a rejected
        re-admission settles through ``submit_hp``'s normal failure path
        (``hp_generated`` is counted at request creation, so re-submitting
        the same task keeps the terminal partition exact)."""
        dec = self.policy.fail_device(idx, self.q.now)
        hp_orphans: list[Task] = []
        for task in dec.preempted:          # every orphan, HP and LP
            ev = self._exec_events.pop(task, None)
            if ev is not None:
                ev.cancel()
            self.client.on_device_lost(task)
            if task.priority == Priority.HIGH:
                hp_orphans.append(task)
        for alloc in dec.reallocations:     # recovered LP orphans
            self._schedule_exec(alloc)
        for task in dec.failed:             # unrecoverable LP orphans
            self.client.on_admit_fail(task)
        for task in hp_orphans:
            sub = self.submit_hp(task)
            if not sub.rejected:
                self.metrics.orphans_recovered += 1
        return dec

    def device_drained(self, idx: int) -> None:
        self.policy.drain_device(idx, self.q.now)

    def device_rejoined(self, idx: int) -> None:
        self.policy.rejoin_device(idx, self.q.now)

    # ------------------------------------------------------------------ #
    # Slot execution                                                     #
    # ------------------------------------------------------------------ #
    def _schedule_exec(self, alloc: Allocation) -> None:
        task = alloc.task
        if self.exact_slots:
            self._exec_events[task] = self.q.push(
                alloc.t_start, lambda: self._start_exact(alloc))
            return

        def start() -> None:
            if task.state != TaskState.ALLOCATED:
                return                  # preempted before execution began
            task.state = TaskState.RUNNING
            actual = self.client.exec_time(task, self.policy.busy_fraction(alloc))
            finish = alloc.t_start + actual
            if finish > alloc.t_end:
                ev = self.q.push(alloc.t_end, lambda: self._violate(task))
            else:
                ev = self.q.push(finish, lambda: self._complete(task))
            self._exec_events[task] = ev

        self._exec_events[task] = self.q.push(alloc.t_start, start)

    def _complete(self, task: Task) -> None:
        now = self.q.now
        self._exec_events.pop(task, None)
        late = now > task.deadline + 1e-9
        self.policy.on_complete(task, now)   # frees the slot's remainder
        self.task_finished(task, late)

    def _violate(self, task: Task) -> None:
        """Task overran its reserved slot; the device terminates it (§7.3)."""
        self._exec_events.pop(task, None)
        task.state = TaskState.VIOLATED
        self.policy.on_violate(task, self.q.now)
        prefix = "hp" if task.priority == Priority.HIGH else "lp"
        self.metrics.count_type(task.task_type, f"{prefix}_failed_runtime")
        if task.priority == Priority.HIGH:
            self.metrics.hp_failed_runtime += 1
        else:
            self.metrics.lp_failed_runtime += 1
        self.client.on_late(task)

    def _start_exact(self, alloc: Allocation) -> None:
        task = alloc.task
        if task.state != TaskState.ALLOCATED:
            return                      # preempted before the slot began
        task.state = TaskState.RUNNING
        self.client.on_start(task)
        self._exec_events[task] = self.q.push(
            alloc.t_end, lambda: self._complete_exact(task))

    def _complete_exact(self, task: Task) -> None:
        if task.state != TaskState.RUNNING:
            return                      # preempted mid-slot
        now = self.q.now
        self._exec_events.pop(task, None)
        # a reserved slot may end past the deadline by its jitter padding —
        # judge lateness against the deadline, exactly like simulated mode
        late = now > task.deadline + 1e-9
        self.policy.on_complete(task, now)
        self.task_finished(task, late)

    # ------------------------------------------------------------------ #
    # Accounting hooks for execution-driving policies                    #
    # ------------------------------------------------------------------ #
    def lp_started(self, task: Task, cores: int, offloaded: bool) -> None:
        """An execution-driving policy started an LP task on ``cores``."""
        m = self.metrics
        m.lp_allocated += 1
        m.count_type(task.task_type, "lp_allocated")
        if task.variant > 0:
            # variant-ladder histogram (DESIGN.md §17): the rung the task
            # was admitted at — covers pre-degraded streaming admissions
            # and the scheduler's degrade-before-reject retries alike
            m.variant_admissions[task.variant] += 1
        bucket = (m.core_alloc_offloaded if offloaded
                  else m.core_alloc_local)
        bucket[cores] += 1
        if offloaded:
            m.lp_offloaded += 1

    def task_finished(self, task: Task, late: bool) -> None:
        """Uniform terminal-outcome accounting — the single path for both
        slot execution modes and execution-driving policies."""
        m = self.metrics
        task.state = TaskState.FAILED if late else TaskState.COMPLETED
        via_preemption = task in self._via_preemption
        # terminal: the membership test above is the set's last use, so an
        # open-ended streaming run doesn't retain every preempting HP task
        self._via_preemption.discard(task)
        prefix = "hp" if task.priority == Priority.HIGH else "lp"
        m.count_type(task.task_type,
                     f"{prefix}_{'failed_runtime' if late else 'completed'}")
        if task.priority == Priority.HIGH:
            if late:
                m.hp_failed_runtime += 1
                self.client.on_late(task)
            else:
                m.hp_completed += 1
                if via_preemption:
                    m.hp_completed_via_preemption += 1
                self.client.on_hp_complete(task)
        elif not late:
            m.lp_completed += 1
            # accuracy-weighted goodput numerator: the admitted rung's
            # benchmark accuracy (1.0 on every ladder-free path; the
            # summary key only appears when the ladder fired)
            m.lp_accuracy_completed += self.net.profile_for(task).accuracy
            if task.offloaded:
                m.lp_offloaded_completed += 1
            self.client.on_lp_complete(task)
        else:
            m.lp_failed_runtime += 1
            self.client.on_late(task)

    def finalize(self) -> None:
        self.policy.finalize(self.q.now)


# ====================================================================== #
# Registered policies                                                    #
# ====================================================================== #
class CalendarPolicy(SchedulingPolicy):
    """Base for slot-based policies backed by the time-slotted calendars."""

    def __init__(self, n_devices: int, net: NetworkConfig, *,
                 capacity: int = 4, metrics: Optional[Metrics] = None,
                 **_ignored) -> None:
        self.state = NetworkState(n_devices, capacity=capacity)
        self.net = net
        self.metrics = metrics if metrics is not None else Metrics()

    def on_complete(self, task: Task, now: float) -> None:
        self.state.devices[task.device].truncate(task, now)

    def on_violate(self, task: Task, now: float) -> None:
        self.state.devices[task.device].release(task)

    def busy_fraction(self, alloc: Allocation) -> float:
        dev = self.state.devices[alloc.device]
        busy = max(0, dev.max_usage(alloc.t_start, alloc.t_end) - alloc.cores)
        return busy / dev.capacity

    # -- device churn (DESIGN.md §16): generic calendar-backed handling - #
    def fail_device(self, idx: int, now: float) -> Decision:
        """Generic churn handling for calendar-backed policies: clear the
        device, cancel the orphans' still-pending link slots (when the
        policy keeps a link-slot registry), and route each LP orphan
        through the policy's own ``reallocate`` settle.  An orphan whose
        policy offers no reallocation path (the protocol default rejects
        without settling) is settled FAILED here — never stranded.  HP
        orphans come back PREEMPTED in ``preempted`` for the dispatcher's
        immediate re-admission."""
        orphans = self.state.fail_device(idx, now)
        links = getattr(self, "links", None)
        for task in orphans:
            if links is not None:
                links.cancel_pending(self.state.link, task.task_id, now)
            task.state = TaskState.PREEMPTED
        dec = Decision(DecisionStatus.ADMITTED, preempted=list(orphans))
        for task in orphans:
            if task.priority == Priority.HIGH:
                continue
            sub = self.reallocate(task, now)
            dec.reallocations.extend(sub.allocations)
            if task.state is TaskState.ALLOCATED:
                continue
            if task.state is not TaskState.FAILED:
                task.state = TaskState.FAILED
                self.metrics.realloc_failure += 1
            dec.failed.append(task)
        self.metrics.device_failures += 1
        self.metrics.orphans_created += len(orphans)
        self.metrics.orphans_recovered += len(dec.reallocations)
        return dec

    def drain_device(self, idx: int, now: float) -> None:
        self.state.drain_device(idx)
        self.metrics.device_drains += 1

    def rejoin_device(self, idx: int, now: float) -> None:
        self.state.rejoin_device(idx)
        self.metrics.device_rejoins += 1


@register_policy("scheduler")
class SchedulerPolicy(CalendarPolicy):
    """The paper's preemption-aware time-slotted scheduler (§4)."""

    def __init__(self, n_devices: int, net: NetworkConfig, *,
                 capacity: int = 4, preemption: bool = True,
                 victim_policy: str = "farthest_deadline",
                 metrics: Optional[Metrics] = None,
                 allow_offload: bool = True,
                 preemption_plane: bool = True,
                 degrade: bool = False, **_ignored) -> None:
        super().__init__(n_devices, net, capacity=capacity, metrics=metrics)
        self.sched = PreemptionAwareScheduler(
            self.state, net, preemption=preemption, metrics=self.metrics,
            victim_policy=victim_policy, allow_offload=allow_offload,
            preemption_plane=preemption_plane, degrade=degrade,
        )

    def decide_hp(self, task: Task, now: float) -> Decision:
        return Decision.from_hp_result(self.sched.allocate_high_priority(task, now))

    def decide_lp(self, request: LowPriorityRequest, now: float) -> Decision:
        return Decision.from_lp_result(self.sched.allocate_low_priority(request, now))

    def decide_lp_batch(
        self, requests: Sequence[LowPriorityRequest], now: float
    ) -> list[Decision]:
        return [Decision.from_lp_result(r)
                for r in self.sched.allocate_low_priority_batch(requests, now)]

    def reallocate(self, task: Task, now: float) -> Decision:
        alloc = self.sched.reallocate(task, now)
        if alloc is None:
            return Decision(DecisionStatus.REJECTED, failed=[task])
        return Decision(DecisionStatus.ADMITTED, allocations=[alloc],
                        predicted_completion=alloc.t_end)

    def fail_device(self, idx: int, now: float) -> Decision:
        # The scheduler's own churn pass: batch victim reallocation with
        # one shared placement context (cheaper than the generic per-orphan
        # path when a loaded device dies), identical settle semantics.
        orphans, reallocs = self.sched.fail_device(idx, now)
        return Decision(
            DecisionStatus.ADMITTED, preempted=orphans,
            reallocations=reallocs,
            failed=[t for t in orphans if t.state is TaskState.FAILED])

    def drain_device(self, idx: int, now: float) -> None:
        self.sched.drain_device(idx, now)

    def rejoin_device(self, idx: int, now: float) -> None:
        self.sched.rejoin_device(idx, now)


@register_policy("no_offload")
class NoOffloadPolicy(SchedulerPolicy):
    """The paper's scheduler with stage-3 offloading disabled: LP tasks may
    only run on their source device (quantifies what the shared network
    buys).  HP admission and preemption are unchanged."""

    def __init__(self, n_devices: int, net: NetworkConfig, **kwargs) -> None:
        kwargs.pop("allow_offload", None)
        super().__init__(n_devices, net, allow_offload=False, **kwargs)


@register_policy("edf_only")
class EDFOnlyPolicy(CalendarPolicy):
    """Greedy earliest-deadline-first baseline (~100-line plugin demo).

    Every task is committed at the earliest feasible calendar slot at
    decision time — source device first, otherwise the device with the
    earliest start after one input transfer.  Minimum core config only, no
    preemption, no §4 time-point sweep, no core upgrades; batches admit in
    deadline order.  What it shows: admission-controlled EDF without the
    paper's preemption/upgrade machinery.
    """

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        # link reservations of each task's latest placement, so an external
        # reallocation can cancel the stale pending ones (shared helper —
        # same bookkeeping PreemptionAwareScheduler applies to its victims).
        self.links = LinkSlotRegistry()

    def decide_hp(self, task: Task, now: float) -> Decision:
        net, link = self.net, self.state.link
        prof = net.profile(task.task_type)
        self.state.gc(now)
        self.links.prune(now)
        dev = self.state.devices[task.source_device]
        if not dev.is_up:
            # HP runs on its (DRAINING/DOWN) home device only: reject.
            return Decision(DecisionStatus.REJECTED, failed=[task])
        msg_dur = net.slot(net.msg.hp_alloc)
        msg_t1 = link.earliest_slot(msg_dur, now)
        arrival = msg_t1 + msg_dur
        t1 = dev.earliest_fit(prof.hp_slot_time, arrival, 1)
        if t1 + prof.hp_exec > task.deadline:
            return Decision(DecisionStatus.REJECTED, failed=[task])
        t2 = t1 + prof.hp_slot_time
        slots = [link.reserve(msg_t1, msg_t1 + msg_dur,
                              ("hp_alloc", task.task_id))]
        dev.reserve(t1, t2, 1, task)
        upd_dur = net.slot(prof.output_bytes)
        slots.append(link.reserve_earliest(upd_dur, t2,
                                           ("update", task.task_id)))
        self.links.record(task.task_id, slots)
        task.state = TaskState.ALLOCATED
        task.device, task.cores = task.source_device, 1
        task.t_start, task.t_end, task.offloaded = t1, t2, False
        alloc = Allocation(task, task.source_device, t1, t2, 1, False)
        return Decision(DecisionStatus.ADMITTED, allocations=[alloc],
                        predicted_completion=t2)

    def _place_lp(self, task: Task, now: float, deadline: float) -> Optional[Allocation]:
        net, link = self.net, self.state.link
        prof = net.profile_for(task)            # the task's ladder rung
        cores = prof.core_options[0]
        proc = prof.lp_slot_time(cores)
        msg_dur = net.slot(net.msg.lp_alloc)
        msg_t1 = link.earliest_slot(msg_dur, now)
        arrival = msg_t1 + msg_dur
        sdev = self.state.devices[task.source_device]
        best_dev, best_t1, offloaded = (
            sdev,
            sdev.earliest_fit(proc, arrival, cores) if sdev.is_up else math.inf,
            False)
        xfer_dur = net.slot(prof.input_bytes)
        xfer_t1 = link.earliest_slot(xfer_dur, arrival)
        t1_off = xfer_t1 + xfer_dur
        for d in self.state.devices:
            if d is sdev or not d.is_up:
                continue
            t1 = d.earliest_fit(proc, t1_off, cores)
            if t1 < best_t1:
                best_dev, best_t1, offloaded = d, t1, True
        if best_t1 + proc > deadline:
            return None
        t1, t2 = best_t1, best_t1 + proc
        slots = [link.reserve(msg_t1, msg_t1 + msg_dur,
                              ("lp_alloc", task.task_id))]
        if offloaded:
            slots.append(link.reserve(xfer_t1, xfer_t1 + xfer_dur,
                                      ("xfer", task.task_id)))
        best_dev.reserve(t1, t2, cores, task)
        upd_dur = net.slot(prof.output_bytes)
        slots.append(link.reserve_earliest(upd_dur, t2,
                                           ("update", task.task_id)))
        self.links.record(task.task_id, slots)
        task.state = TaskState.ALLOCATED
        task.device, task.cores = best_dev.device, cores
        task.t_start, task.t_end, task.offloaded = t1, t2, offloaded
        return Allocation(task, best_dev.device, t1, t2, cores, offloaded)

    def decide_lp(self, request: LowPriorityRequest, now: float) -> Decision:
        return self.decide_lp_batch([request], now)[0]

    def decide_lp_batch(
        self, requests: Sequence[LowPriorityRequest], now: float
    ) -> list[Decision]:
        self.state.gc(now)
        self.links.prune(now)
        decs = [Decision(DecisionStatus.REJECTED) for _ in requests]
        pool = [(req.deadline, i, ridx, task)
                for ridx, req in enumerate(requests)
                for i, task in enumerate(req.tasks)
                if task.state == TaskState.PENDING]
        pool.sort(key=lambda item: (item[0], item[2], item[1]))
        for deadline, _, ridx, task in pool:
            alloc = self._place_lp(task, now, deadline)
            if alloc is None:
                task.state = TaskState.FAILED
                decs[ridx].failed.append(task)
            else:
                decs[ridx].allocations.append(alloc)
                decs[ridx].status = DecisionStatus.ADMITTED
        return decs

    def reallocate(self, task: Task, now: float) -> Decision:
        # Tear down the previous placement first (same hygiene as the
        # scheduler): release the device slot, cancel pending link slots.
        if task.device is not None:
            self.state.devices[task.device].release(task)
        self.links.cancel_pending(self.state.link, task.task_id, now)
        alloc = self._place_lp(task, now, task.deadline)
        if alloc is None:
            task.state = TaskState.FAILED
            self.metrics.realloc_failure += 1
            return Decision(DecisionStatus.REJECTED, failed=[task])
        self.metrics.realloc_success += 1
        return Decision(DecisionStatus.ADMITTED, allocations=[alloc],
                        predicted_completion=alloc.t_end)


# Workstealer baselines register themselves on import (kept in their own
# module: they bring a processor-sharing execution model with them).
from . import workstealer as _workstealer  # noqa: E402,F401  (registration)
# The offline optimal-placement oracle (quality reference, DESIGN.md §13).
from . import oracle as _oracle  # noqa: E402,F401  (registration)
