"""Streaming serving engine: sustained-traffic admission with backpressure,
load shedding, and incremental SLO telemetry (DESIGN.md §14).

The closed-workload runtimes (``sim/experiment.py``, the one-shot
``serving/engine.py`` submit/run) materialise their whole workload up
front and post-process per-run lists at the end.  This module is the
open-ended counterpart: requests arrive as an (possibly infinite) stream,
are buffered in a **bounded admission queue** with explicit backpressure
signals, and are admitted in **rolling windows** through the same
:class:`~repro.core.policy.PolicyDispatcher` every other runtime uses —
one ``NetworkState`` (and therefore one dirty-mark-refreshed probe plane,
DESIGN.md §10) lives for the whole run, so window *k+1* reuses the plane
window *k* left behind instead of rebuilding it.

Memory is flat by construction: the queue is bounded, terminal requests
are dropped as soon as their last task resolves, ``Metrics`` latency
lists are swapped for :class:`~repro.core.telemetry.BoundedSeries`
sketches, and all telemetry lives in fixed-size structures
(``core/telemetry.py``).  ``benchmarks/soak.py`` pushes ≥10^6 requests
through a 1024-device network and gates on RSS staying flat.

Load shedding is pluggable (``@register_shed_policy``):

* ``reject_newest``  — queue full ⇒ the incoming request is shed.
* ``reject_cheapest`` — queue full ⇒ shed the least valuable queued work
  (LP before HP, then smallest estimated core-seconds, then newest).
* ``degrade`` — at the soft watermark, walk queued LP requests one rung
  down their task type's variant ladder (DESIGN.md §17; for ladder-free
  profiles the single legacy rung pins tasks to ``core_options[0]`` — the
  scheduler's upgrade pass skips them); a full queue still sheds like
  ``reject_cheapest``.

Backpressure is a three-state signal returned by :meth:`StreamingEngine.offer`:
``ACCEPTED`` (below the watermark), ``SOFT`` (queue above its high
watermark — slow down), ``SHED`` (the offered request was dropped).
"""
from __future__ import annotations

import enum
import itertools
import math
from collections import deque
from dataclasses import dataclass
from time import perf_counter
from typing import Any, Callable, Iterable, Optional

from ..core.metrics import Metrics
from ..core.network import NetworkConfig, resolve_network
from ..core.policy import (
    DispatchClient,
    PolicyDispatcher,
    create_policy,
    SchedulingPolicy,
)
from ..core.profiles import WorkloadSpec
from ..core.task import LowPriorityRequest, Priority, Task, TaskState
from ..core.telemetry import BoundedSeries, StreamTelemetry
from ..sim.events import EventQueue

_EPS = 1e-9


# ====================================================================== #
# Submit-boundary validation                                             #
# ====================================================================== #
def validate_submission(
    *,
    priority: Priority,
    deadline: float,
    now: float = 0.0,
    n_tasks: int = 1,
    max_new_tokens: Optional[int] = None,
    task_type: Optional[str] = None,
    spec: Optional[WorkloadSpec] = None,
) -> None:
    """Reject malformed submissions with a ``ValueError`` naming the field.

    Shared by the streaming engine's :meth:`StreamingEngine.offer` and the
    one-shot serving engine's ``submit`` — bad requests die at the boundary
    instead of corrupting calendars deep inside the event loop.
    """
    if not isinstance(priority, Priority):
        raise ValueError(
            f"priority must be a repro_torch.core.task.Priority, got {priority!r}")
    if isinstance(deadline, bool) or not isinstance(deadline, (int, float)):
        raise ValueError(f"deadline must be a number, got {deadline!r}")
    if math.isnan(deadline):
        raise ValueError("deadline is NaN")
    if math.isinf(deadline):
        raise ValueError("deadline must be finite")
    if deadline <= now:
        raise ValueError(
            f"deadline {deadline:g} is in the past (now={now:g})")
    if not isinstance(n_tasks, int) or isinstance(n_tasks, bool) \
            or n_tasks < 1:
        raise ValueError(f"n_tasks must be a positive int, got {n_tasks!r}")
    if max_new_tokens is not None and (
            not isinstance(max_new_tokens, int)
            or isinstance(max_new_tokens, bool) or max_new_tokens < 1):
        raise ValueError(
            f"max_new_tokens must be a positive int, got {max_new_tokens!r}")
    if task_type is not None and spec is not None:
        try:
            spec.profile(task_type)
        except (KeyError, ValueError) as e:
            raise ValueError(f"unknown task_type {task_type!r}: {e}") from None


# ====================================================================== #
# Requests and backpressure                                              #
# ====================================================================== #
class Backpressure(enum.Enum):
    ACCEPTED = "accepted"    # queued below the high watermark
    SOFT = "soft"            # queued, but the queue is past its watermark
    SHED = "shed"            # the offered request was dropped


@dataclass(eq=False)
class StreamRequest:
    """One unit of streamed work: an HP task or an LP task set."""

    priority: Priority
    deadline: float                       # absolute virtual time
    home_device: int = 0
    n_tasks: int = 1                      # LP set size (HP: always 1 task)
    task_type: Optional[str] = None
    max_new_tokens: Optional[int] = None
    arrival: float = 0.0
    rid: Optional[int] = None             # assigned by the engine
    # lifecycle: queued -> admitted -> done | failed, or queued -> shed
    state: str = "queued"
    # Variant-ladder rung (DESIGN.md §17) the request is currently queued
    # at; the degrade shed policy walks it down, and admission stamps it
    # onto the request's tasks.  0 = full accuracy.
    variant: int = 0
    shed_reason: Optional[str] = None     # "queue_full" | "expired"
    est_cost: float = 0.0                 # estimated core-seconds (shedding)
    completed_at: float = -1.0
    _remaining: int = 0                   # live tasks still unresolved
    _failed: bool = False                 # any task failed / missed deadline

    @property
    def degraded(self) -> bool:
        """Deprecated one-bit view of the variant ladder (pre-ladder
        callers keep working): any rung below 0 counts as degraded."""
        return self.variant > 0

    @degraded.setter
    def degraded(self, flag: bool) -> None:
        self.variant = max(self.variant, 1) if flag else 0


@dataclass(frozen=True)
class StreamArrival:
    """A lightweight arrival record (what ``sim/openended.py`` yields).

    ``rel_deadline`` is relative to ``t``; ``None`` derives the deadline
    from the workload profile (HP: ``profile.hp_deadline``; LP: the
    profile's ``lp_deadline`` or the engine's default).
    """

    t: float
    device: int
    priority: Priority
    n_tasks: int = 1
    task_type: Optional[str] = None
    rel_deadline: Optional[float] = None


# ====================================================================== #
# Bounded admission queue                                                #
# ====================================================================== #
class AdmissionQueue:
    """FIFO queue with a hard capacity and a soft high watermark.

    Shed victims are removed *lazily*: :meth:`drop` only decrements the
    live count and the entry is skipped when a drain reaches it, so victim
    removal is O(1) regardless of queue depth.  Tombstones are bounded by
    one window's arrivals (every drain sweeps them out).
    """

    def __init__(self, capacity: int = 4096,
                 soft_watermark: float = 0.75) -> None:
        if capacity < 1:
            raise ValueError("AdmissionQueue capacity must be >= 1")
        if not (0.0 < soft_watermark <= 1.0):
            raise ValueError("soft_watermark must be in (0, 1]")
        self.capacity = capacity
        self.soft_level = max(1, int(capacity * soft_watermark))
        self._dq: deque[StreamRequest] = deque()
        self.live = 0

    def __len__(self) -> int:
        return self.live

    @property
    def full(self) -> bool:
        return self.live >= self.capacity

    @property
    def soft(self) -> bool:
        return self.live >= self.soft_level

    def push(self, req: StreamRequest) -> None:
        self._dq.append(req)
        self.live += 1

    def drop(self, req: StreamRequest) -> None:
        """Logically remove a victim (caller marks its state non-queued)."""
        self.live -= 1

    def pop_live(self) -> Optional[StreamRequest]:
        while self._dq:
            req = self._dq.popleft()
            if req.state == "queued":
                self.live -= 1
                return req
        return None

    def iter_live(self) -> Iterable[StreamRequest]:
        return (r for r in self._dq if r.state == "queued")


# ====================================================================== #
# Load-shedding policies                                                 #
# ====================================================================== #
_SHED_REGISTRY: dict[str, Callable[..., "ShedPolicy"]] = {}


def register_shed_policy(name: str):
    """Class decorator: make a shed policy constructible by name."""

    def deco(factory):
        if name in _SHED_REGISTRY:
            raise ValueError(f"shed policy {name!r} already registered")
        _SHED_REGISTRY[name] = factory
        factory.name = name
        return factory

    return deco


def registered_shed_policies() -> tuple[str, ...]:
    return tuple(sorted(_SHED_REGISTRY))


def create_shed_policy(name: str, **kwargs) -> "ShedPolicy":
    try:
        factory = _SHED_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown shed policy {name!r}; registered: "
            + ", ".join(registered_shed_policies())
        ) from None
    return factory(**kwargs)


class ShedPolicy:
    """What to drop (or downgrade) when the admission queue saturates."""

    name: str = "?"

    def on_pressure(self, queue: AdmissionQueue,
                    engine: "StreamingEngine") -> None:
        """The queue crossed its soft watermark (rising edge only)."""

    def pick_victim(self, queue: AdmissionQueue, incoming: StreamRequest,
                    engine: "StreamingEngine") -> StreamRequest:
        """The queue is full: return the request to shed — either
        ``incoming`` or a currently queued request."""
        raise NotImplementedError


@register_shed_policy("reject_newest")
class RejectNewest(ShedPolicy):
    """Tail drop: a full queue sheds the incoming request."""

    def pick_victim(self, queue, incoming, engine):
        return incoming


@register_shed_policy("reject_cheapest")
class RejectCheapest(ShedPolicy):
    """Shed the least valuable work: LP before HP, then the smallest
    estimated core-seconds, then the newest arrival."""

    @staticmethod
    def _key(req: StreamRequest):
        return (1 if req.priority == Priority.HIGH else 0,
                req.est_cost, -(req.rid or 0))

    def pick_victim(self, queue, incoming, engine):
        victim = incoming
        vkey = self._key(incoming)
        for r in queue.iter_live():
            k = self._key(r)
            if k < vkey:
                victim, vkey = r, k
        return victim


@register_shed_policy("degrade")
class DegradeThenReject(RejectCheapest):
    """Degrade before dropping: at the soft watermark every queued LP
    request steps one rung down its task type's variant ladder (DESIGN.md
    §17); a full queue degrades the incoming LP request too, then sheds
    like ``reject_cheapest``.

    :meth:`degrade` walks the real ladder: each call moves the request one
    rung deeper and re-estimates its shed cost at the new rung, so repeated
    pressure edges keep cutting until the ladder bottoms out.  For a
    ladder-free profile the single legacy rung pins the request's tasks to
    ``core_options[0]`` via ``Task.degraded`` (the scheduler's core-upgrade
    pass skips them) — exactly the pre-ladder behavior.
    """

    def degrade(self, req: StreamRequest, engine: "StreamingEngine") -> bool:
        prof = engine.net.profile(req.task_type)
        if req.variant + 1 < prof.n_variants:
            req.variant += 1
        elif prof.n_variants == 1 and req.variant == 0:
            req.variant = 1      # legacy pin: base stats at minimum cores
        else:
            return False         # ladder exhausted
        # re-estimate the shed cost at the admitted rung, so the
        # reject_cheapest fallback ranks degraded work by what it now costs
        rung = prof.variant_profile(req.variant)
        cores = rung.core_options[0]
        req.est_cost = req.n_tasks * rung.lp_slot_time(cores) * cores
        engine.telemetry.degraded += 1
        engine.metrics.lp_degraded += 1
        return True

    def on_pressure(self, queue, engine):
        for r in queue.iter_live():
            if r.priority == Priority.LOW:
                self.degrade(r, engine)

    def pick_victim(self, queue, incoming, engine):
        if incoming.priority == Priority.LOW:
            self.degrade(incoming, engine)
        return super().pick_victim(queue, incoming, engine)


# ====================================================================== #
# Dispatcher client: terminal bookkeeping without a final sweep          #
# ====================================================================== #
class _StreamClient(DispatchClient):
    def __init__(self, engine: "StreamingEngine") -> None:
        self.engine = engine

    def on_start(self, task: Task) -> None:
        hook = self.engine.compute_hook
        if hook is not None:
            hook(task)

    def on_hp_complete(self, task: Task) -> None:
        self.engine._task_terminal(task, ok=True)

    def on_lp_complete(self, task: Task) -> None:
        self.engine._task_terminal(task, ok=True)

    def on_admit_fail(self, task: Task) -> None:
        self.engine._task_terminal(task, ok=False)

    def on_late(self, task: Task) -> None:
        self.engine._task_terminal(task, ok=False)

    def on_device_lost(self, task: Task) -> None:
        # The orphan is transient, not terminal: recovery (or failure)
        # settles through the normal completion / admit-fail hooks.
        self.engine.telemetry.orphans_seen += 1


# ====================================================================== #
# The streaming engine                                                   #
# ====================================================================== #
class StreamingEngine:
    """Windowed streaming admission over the shared policy dispatcher.

    One instance holds one :class:`EventQueue`, one policy (and therefore
    one ``NetworkState`` whose probe plane persists across windows), one
    bounded :class:`AdmissionQueue` and one :class:`StreamTelemetry`.
    Requests enter through :meth:`offer` (returning a
    :class:`Backpressure` signal) or the :meth:`run` pump, which drains a
    source iterator window by window.

    Execution is exact-slot (``PolicyDispatcher(exact_slots=True)``):
    tasks complete at their reserved slot end, optionally invoking
    ``compute_hook`` at slot start — the jax engine mounts real decode
    work there; the soak benchmark leaves it ``None``.
    """

    def __init__(
        self,
        n_devices: int,
        *,
        net: Optional[NetworkConfig] = None,
        workload: str = "paper",
        policy: str = "scheduler",
        queue_capacity: int = 4096,
        soft_watermark: float = 0.75,
        shed: str = "reject_newest",
        window: float = 0.25,
        window_budget: Optional[int] = None,
        default_lp_deadline: float = 30.0,
        keep_done: int = 0,
        compute_hook: Optional[Callable[[Task], None]] = None,
        telemetry: Optional[StreamTelemetry] = None,
        policy_kwargs: Optional[dict] = None,
    ) -> None:
        if window <= 0.0:
            raise ValueError("window must be positive")
        if window_budget is not None and window_budget < 1:
            raise ValueError("window_budget must be >= 1 (or None)")
        self.net = resolve_network(net, workload)
        self.window = window
        self.window_budget = window_budget
        self.default_lp_deadline = default_lp_deadline
        self.compute_hook = compute_hook
        self.q = EventQueue()
        self.metrics = Metrics(scenario=f"stream_{policy}")
        # Open-ended run: cap the per-call latency lists with sketches so
        # metrics memory stays flat (telemetry.BoundedSeries is
        # list-compatible for the scheduler's appends).
        for f in ("t_hp_initial", "t_hp_preempt", "t_lp_alloc",
                  "t_realloc", "t_evict"):
            setattr(self.metrics, f, BoundedSeries())
        self.policy: SchedulingPolicy = create_policy(
            policy, n_devices=n_devices, net=self.net,
            metrics=self.metrics, **(policy_kwargs or {}))
        if self.policy.drives_execution:
            raise ValueError(
                f"policy {policy!r} drives its own execution model; the "
                "streaming engine supports slot-based policies only")
        self.dispatcher = PolicyDispatcher(
            self.policy, self.q, self.net, self.metrics,
            client=_StreamClient(self), exact_slots=True)
        # device calendars (churn drivers and tests read lifecycle off this;
        # None for policies without a NetworkState)
        self.state = getattr(self.policy, "state", None)
        self.queue = AdmissionQueue(queue_capacity, soft_watermark)
        self.shed_policy = create_shed_policy(shed)
        self.telemetry = telemetry if telemetry is not None \
            else StreamTelemetry()
        self.done: deque[StreamRequest] = deque(maxlen=max(keep_done, 1)) \
            if keep_done > 0 else deque(maxlen=0)
        self._by_task: dict[Task, StreamRequest] = {}
        self._rids = itertools.count()
        self._soft = False              # watermark hysteresis (rising edge)
        self.unresolved = 0             # safety valve; must stay 0

    # ------------------------------------------------------------------ #
    # Offer path                                                         #
    # ------------------------------------------------------------------ #
    def request_from_arrival(self, arr: StreamArrival) -> StreamRequest:
        """Materialise a :class:`StreamRequest` from an arrival record,
        deriving the absolute deadline from the workload profile."""
        prof = self.net.profile(arr.task_type)
        if arr.priority == Priority.HIGH:
            deadline = (arr.t + arr.rel_deadline
                        if arr.rel_deadline is not None
                        else prof.hp_deadline(arr.t))
            n_tasks = 1
        else:
            rel = arr.rel_deadline if arr.rel_deadline is not None else (
                prof.lp_deadline if prof.lp_deadline is not None
                else self.default_lp_deadline)
            deadline = arr.t + rel
            n_tasks = arr.n_tasks
        return StreamRequest(
            priority=arr.priority, deadline=deadline, home_device=arr.device,
            n_tasks=n_tasks, task_type=arr.task_type, arrival=arr.t)

    def offer(self, req: StreamRequest,
              now: Optional[float] = None) -> Backpressure:
        """Offer one request to the admission queue.

        Validates at the boundary (``ValueError`` names the offending
        field), accounts it as generated, and returns the backpressure
        signal the producer should react to.
        """
        t = self.q.now if now is None else now
        validate_submission(
            priority=req.priority, deadline=req.deadline, now=t,
            n_tasks=req.n_tasks, max_new_tokens=req.max_new_tokens,
            task_type=req.task_type, spec=self.net.spec)
        if req.rid is None:
            req.rid = next(self._rids)
        if req.arrival == 0.0 and t > 0.0:
            req.arrival = t
        prof = self.net.profile(req.task_type)
        if req.priority == Priority.HIGH:
            req.est_cost = prof.hp_slot_time
        else:
            cores = prof.core_options[0]
            req.est_cost = req.n_tasks * prof.lp_slot_time(cores) * cores
        m = self.metrics
        self.telemetry.offered += 1
        if req.priority == Priority.HIGH:
            m.hp_generated += 1
            m.count_type(req.task_type, "hp_generated")
        else:
            m.lp_generated += req.n_tasks
            m.lp_requests_total += 1
            m.count_type(req.task_type, "lp_generated", req.n_tasks)

        if self.queue.full:
            victim = self.shed_policy.pick_victim(self.queue, req, self)
            if victim is req:
                self._shed(req, "queue_full")
                return Backpressure.SHED
            self.queue.drop(victim)
            self._shed(victim, "queue_full")
            self.queue.push(req)
        else:
            self.queue.push(req)

        if self.queue.soft:
            if not self._soft:
                self._soft = True
                self.shed_policy.on_pressure(self.queue, self)
            self.telemetry.soft_signals += 1
            return Backpressure.SOFT
        return Backpressure.ACCEPTED

    def _shed(self, req: StreamRequest, reason: str) -> None:
        req.state = "shed"
        req.shed_reason = reason
        m = self.metrics
        if req.priority == Priority.HIGH:
            m.hp_shed += 1
            m.count_type(req.task_type, "hp_shed")
        else:
            m.lp_shed += req.n_tasks
            m.count_type(req.task_type, "lp_shed", req.n_tasks)
        if reason == "expired":
            self.telemetry.shed_expired += 1
        else:
            self.telemetry.shed_queue_full += 1
        self.telemetry.slo.record(req.task_type, attained=False)
        self.done.append(req)

    # ------------------------------------------------------------------ #
    # Window drain                                                       #
    # ------------------------------------------------------------------ #
    def flush_window(self, now: Optional[float] = None) -> int:
        """Drain (up to ``window_budget``) queued requests into the
        dispatcher at ``now``.  Returns the number admitted."""
        if now is None:
            now = self.q.now
        elif now > self.q.now:
            # direct callers (run() has already drained events to ``now``)
            self.q.now = now
        self.telemetry.windows += 1
        self.telemetry.queue_depth.sample(now, float(self.queue.live))
        budget = self.window_budget if self.window_budget is not None \
            else (1 << 62)
        hp_batch: list[tuple[StreamRequest, Task]] = []
        lp_batch: list[tuple[StreamRequest, LowPriorityRequest]] = []
        admitted = 0
        while self.queue.live and admitted < budget:
            req = self.queue.pop_live()
            if req is None:
                break
            if req.deadline <= now + _EPS:
                self._shed(req, "expired")
                continue
            admitted += 1
            req.state = "admitted"
            if req.priority == Priority.HIGH:
                task = Task(
                    priority=Priority.HIGH, source_device=req.home_device,
                    deadline=req.deadline, frame_id=req.rid,
                    task_type=req.task_type, created_at=req.arrival)
                req._remaining = 1
                self._by_task[task] = req
                hp_batch.append((req, task))
            else:
                lr = LowPriorityRequest(
                    source_device=req.home_device, deadline=req.deadline,
                    frame_id=req.rid, n_tasks=req.n_tasks,
                    created_at=req.arrival, task_type=req.task_type)
                tasks = lr.make_tasks()
                if req.variant:
                    for task in tasks:
                        task.variant = req.variant
                req._remaining = len(tasks)
                for task in tasks:
                    self._by_task[task] = req
                lp_batch.append((req, lr))
        if self.queue.live < self.queue.soft_level:
            self._soft = False
        tel = self.telemetry
        # HP first — they may preempt the LP work admitted the window
        # before, and the admission latency of each is a gated quantity.
        for req, task in hp_batch:
            t0 = perf_counter()
            dec = self.dispatcher.submit_hp(task)
            tel.admission.record(perf_counter() - t0)
            tel.admitted_hp += 1
            self._settle_failed_victims(dec)
        if lp_batch:
            t0 = perf_counter()
            self.dispatcher.submit_lp_batch([lr for _, lr in lp_batch])
            share = (perf_counter() - t0) / len(lp_batch)
            tel.admitted_lp += len(lp_batch)
            tel.admission.record_many([share] * len(lp_batch))
        return admitted

    def _settle_failed_victims(self, dec) -> None:
        # A preempting HP admission may strand a victim whose reallocation
        # failed; no completion event will ever fire for it, so its request
        # settles here (the dispatcher already counted realloc_failure).
        for victim in dec.preempted:
            if victim.state == TaskState.FAILED and victim in self._by_task:
                self._task_terminal(victim, ok=False)

    def _task_terminal(self, task: Task, ok: bool) -> None:
        req = self._by_task.pop(task, None)
        if req is None:
            return
        req._remaining -= 1
        if not ok:
            req._failed = True
        if req._remaining > 0:
            return
        now = self.q.now
        req.completed_at = now
        attained = not req._failed
        req.state = "done" if attained else "failed"
        if attained:
            self.telemetry.e2e.record(max(now - req.arrival, 0.0))
        self.telemetry.slo.record(req.task_type, attained)
        self.done.append(req)

    # ------------------------------------------------------------------ #
    # Device churn (DESIGN.md §16)                                       #
    # ------------------------------------------------------------------ #
    def fail_device(self, idx: int, now: Optional[float] = None):
        """Hard-fail a device at ``now``: orphan its in-flight work and
        drive recovery through the dispatcher (LP orphans re-placed or
        FAILED, HP orphans re-admitted ahead of the next window)."""
        t = self._advance(now)
        dec = self.dispatcher.device_lost(idx)
        tel = self.telemetry
        tel.devices_failed += 1
        tel.orphans_recovered += len(dec.reallocations)
        for alloc in dec.reallocations:
            tel.recovery_delay.record(max(alloc.t_start - t, 0.0))
        for task in dec.preempted:
            if task.priority == Priority.HIGH \
                    and task.state is not TaskState.FAILED:
                tel.orphans_recovered += 1
        return dec

    def drain_device(self, idx: int, now: Optional[float] = None) -> None:
        """Stop admitting onto a device; its in-flight work runs out."""
        self._advance(now)
        self.dispatcher.device_drained(idx)
        self.telemetry.devices_drained += 1

    def rejoin_device(self, idx: int, now: Optional[float] = None) -> None:
        """Bring a DOWN/DRAINING device back with a cleared calendar."""
        self._advance(now)
        self.dispatcher.device_rejoined(idx)
        self.telemetry.devices_rejoined += 1

    def _advance(self, now: Optional[float]) -> float:
        if now is not None and now > self.q.now:
            self.q.run(until=now)
            self.q.now = max(self.q.now, now)
        return self.q.now

    def _apply_churn_event(self, ev) -> None:
        """Apply one :class:`~repro.sim.churn.ChurnEvent` at its timestamp."""
        if ev.kind == "fail":
            self.fail_device(ev.device, now=ev.t)
        elif ev.kind == "drain":
            self.drain_device(ev.device, now=ev.t)
        elif ev.kind == "rejoin":
            self.rejoin_device(ev.device, now=ev.t)
        elif ev.kind == "link":
            # Time-varying link degradation: occupy the shared link for the
            # event's duration so concurrent offloads queue behind it.
            t = self._advance(ev.t)
            state = self.state
            if state is not None and ev.duration > 0.0:
                state.link.reserve(t, t + ev.duration, ("churn", ev.device))
        else:
            raise ValueError(f"unknown churn event kind {ev.kind!r}")

    # ------------------------------------------------------------------ #
    # The pump                                                           #
    # ------------------------------------------------------------------ #
    def run(
        self,
        source: Iterable,
        *,
        max_requests: Optional[int] = None,
        until: Optional[float] = None,
        on_window: Optional[Callable[["StreamingEngine"], None]] = None,
        churn: Optional[Iterable] = None,
    ) -> dict[str, Any]:
        """Pump a source of :class:`StreamArrival` / :class:`StreamRequest`
        through windowed admission until the source (or ``max_requests`` /
        ``until``) is exhausted and all admitted work has settled.

        ``on_window`` runs after every window flush (soak's RSS sampler).
        ``churn`` is an optional time-sorted stream of
        :class:`~repro.sim.churn.ChurnEvent` records applied at their
        timestamps as windows advance (``None`` — the default — executes
        zero churn code, so churn-free runs stay bit-identical).
        """
        it = iter(source)
        offered = 0
        churn_events = deque(churn) if churn is not None else None

        def pull():
            nonlocal offered
            if max_requests is not None and offered >= max_requests:
                return None
            nxt = next(it, None)
            if nxt is None:
                return None
            if not isinstance(nxt, StreamRequest):
                nxt = self.request_from_arrival(nxt)
            if until is not None and nxt.arrival >= until:
                return None
            offered += 1
            return nxt

        nxt = pull()
        while nxt is not None or self.queue.live:
            w_end = self.q.now + self.window
            if nxt is not None and not self.queue.live \
                    and nxt.arrival > w_end:
                # idle fast-forward: jump to the window holding the next
                # arrival instead of spinning empty windows
                w_end = nxt.arrival + self.window
            while nxt is not None and nxt.arrival <= w_end:
                self.offer(nxt, now=nxt.arrival)
                nxt = pull()
            if churn_events:
                # lifecycle events land at their exact timestamps: _advance
                # drains the event queue up to ev.t first, so completions
                # scheduled before the failure still fire before it
                while churn_events and churn_events[0].t <= w_end:
                    self._apply_churn_event(churn_events.popleft())
            self.q.run(until=w_end)
            self.q.now = max(self.q.now, w_end)
            self.flush_window(w_end)
            if on_window is not None:
                on_window(self)
        if churn_events:
            # events past the last arrival window still interleave with the
            # tail of admitted work draining below
            while churn_events:
                self._apply_churn_event(churn_events.popleft())
        self.q.run()
        self.dispatcher.finalize()
        if self._by_task:
            # must be unreachable: every admitted task resolves through a
            # client hook.  Counted (not asserted) so a soak surfaces it.
            self.unresolved += len(self._by_task)
            self._by_task.clear()
        return self.report()

    # ------------------------------------------------------------------ #
    def report(self) -> dict[str, Any]:
        return {
            "metrics": self.metrics.summary(),
            "telemetry": self.telemetry.snapshot(),
            "in_flight": len(self._by_task),
            "queued": self.queue.live,
            "unresolved": self.unresolved,
        }
