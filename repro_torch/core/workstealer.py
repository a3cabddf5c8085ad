"""Workstealer baselines as registered ``SchedulingPolicy`` plugins.

Centralised (global job queue) and decentralised (per-device queues with
random polling) workstealing, with a processor-sharing execution model:

Workstealers perform no admission control: devices rashly execute
whatever they steal (paper §8 "rash task placement decisions").  Cores
are therefore *oversubscribed*, which the paper reports as middleware
+ concurrent-DNN degradation (11.611 s benchmarked tasks averaging
~14.5 s).  We model execution as processor sharing: each running task
progresses at rate cores * min(1, capacity/demand); HP tasks addition-
ally pay a GIL/middleware interference penalty when the device is
oversubscribed (the Python inference manager competes with TFLite
worker threads).

These policies set ``drives_execution = True``: they run their own
event-driven execution through the host dispatcher (event queue, shared
rng, noise model) and report outcomes via the dispatcher's uniform
accounting hooks (``lp_started`` / ``task_finished``), so their metrics
are directly comparable with the slot-based disciplines.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from .metrics import Metrics
from .network import NetworkConfig
from .policy import Decision, DecisionStatus, SchedulingPolicy, register_policy
from .task import LowPriorityRequest, Priority, Task, TaskState
from .victims import select_victim


class _Run:
    __slots__ = ("work", "cores")

    def __init__(self, work: float, cores: int) -> None:
        self.work = work        # remaining core-seconds
        self.cores = cores


class _WSDevice:
    __slots__ = ("idx", "capacity", "running", "queue", "last", "event",
                 "inflight")

    def __init__(self, idx: int, capacity: int = 4) -> None:
        self.idx = idx
        self.capacity = capacity
        self.running: dict[Task, _Run] = {}
        self.queue: deque[Task] = deque()
        self.last = 0.0          # last time `work` values were advanced
        self.event = None
        self.inflight = 0        # cores reserved by steals still in transfer

    @property
    def demand(self) -> int:
        return sum(r.cores for r in self.running.values())

    @property
    def committed(self) -> int:
        """Cores running or promised (blocks further steals)."""
        return self.demand + self.inflight

    def share(self) -> float:
        d = self.demand
        return 1.0 if d <= self.capacity else self.capacity / d


class WorkstealingPolicy(SchedulingPolicy):
    """Centralised (global queue) or decentralised (per-device, random polls)."""

    drives_execution = True

    # HP interference coefficient: rate *= 1/(1 + GIL_COEF * over/capacity)
    # when the device is oversubscribed (see module docstring).
    GIL_COEF = 0.6
    # Zombie grace: a late task keeps burning cores for this fraction of a
    # frame period past its deadline before the violation kill lands
    # (detection + violation message + manager teardown are not instant).
    # Calibrated against the paper's Fig 2a workstealer frame counts.
    KILL_GRACE = 1.0

    def __init__(self, n_devices: int, net: NetworkConfig, *,
                 central: bool, capacity: int = 4, preemption: bool = True,
                 metrics: Optional[Metrics] = None, **_ignored) -> None:
        self.central = central
        self.net = net
        self.preemption = preemption
        self.metrics = metrics if metrics is not None else Metrics()
        self.devices = [_WSDevice(d, capacity) for d in range(n_devices)]
        self.global_queue: deque[Task] = deque()
        self._preempt_pending: set[Task] = set()
        self._polling: set[int] = set()
        # Stacked committed-cores vector (the workstealer's probe plane):
        # kept in sync by every demand/in-flight change so ``_kick_all``
        # selects stealable devices with one vectorized compare instead of
        # a per-device Python sweep.  A device filtered out here is exactly
        # one whose ``_kick`` would be a no-op, so decisions are unchanged.
        self._committed = np.zeros(n_devices, dtype=np.int64)
        self._cap_arr = np.full(n_devices, capacity, dtype=np.int64)

    # -- processor-sharing core ------------------------------------------- #
    def _hp_penalty(self, dev: _WSDevice) -> float:
        over = max(0, dev.demand - dev.capacity)
        return 1.0 / (1.0 + self.GIL_COEF * over / dev.capacity)

    def _rate(self, dev: _WSDevice, task: Task, run: _Run) -> float:
        rate = run.cores * dev.share()
        if task.priority == Priority.HIGH:
            rate *= self._hp_penalty(dev)
        return rate

    def _advance(self, dev: _WSDevice) -> None:
        """Drain elapsed progress into every running task's `work`."""
        now = self.host.q.now
        dt = now - dev.last
        if dt > 0:
            for task, run in dev.running.items():
                run.work -= dt * self._rate(dev, task, run)
        dev.last = now

    def _reschedule(self, dev: _WSDevice) -> None:
        """(Re)arm the next-completion event after any demand change."""
        if dev.event is not None:
            dev.event.cancel()
            dev.event = None
        if not dev.running:
            return
        soonest = min(
            run.work / max(self._rate(dev, task, run), 1e-12)
            for task, run in dev.running.items()
        )
        dev.event = self.host.q.push(
            self.host.q.now + max(soonest, 0.0), lambda: self._on_finish(dev)
        )

    def _on_finish(self, dev: _WSDevice) -> None:
        dev.event = None
        self._advance(dev)
        done = [t for t, r in dev.running.items() if r.work <= 1e-6]
        for task in done:
            run = dev.running.pop(task)
            self._committed[dev.idx] -= run.cores
            self._complete(dev, task)
        self._kick(dev)
        self._kick_all()
        self._reschedule(dev)

    def _start(self, dev: _WSDevice, task: Task, cores: int) -> None:
        host = self.host
        self._advance(dev)
        task.device, task.cores = dev.idx, cores
        task.offloaded = task.offloaded or (
            task.priority == Priority.LOW and dev.idx != task.source_device
        )
        task.state = TaskState.RUNNING
        prof = self.net.profile(task.task_type)
        if task.priority == Priority.HIGH:
            base = prof.hp_exec
            sigma = host.hp_noise_sigma
        else:
            base = prof.lp_proc_time(cores)
            sigma = host.lp_noise_sigma
        work = base * cores
        if host.exec_noise:
            work = max(0.05, work + host.rng.gauss(0.0, sigma * cores))
        dev.running[task] = _Run(work, cores)
        self._committed[dev.idx] += cores
        # The inference manager terminates tasks that overrun their deadline
        # (paper §7.3 task-violation messages) — partial work is wasted.
        if task.priority == Priority.LOW:
            host.q.push(task.deadline + self.KILL_GRACE * self.net.frame_period,
                        lambda: self._kill_if_late(dev, task))
        self._reschedule(dev)

    def _kill_if_late(self, dev: _WSDevice, task: Task) -> None:
        if task not in dev.running:
            return
        self._advance(dev)
        run = dev.running.pop(task)
        self._committed[dev.idx] -= run.cores
        task.state = TaskState.FAILED
        if task in self._preempt_pending:
            # A re-stolen victim killed late: its reallocation failed to
            # produce an on-time completion — one terminal bucket only.
            self._preempt_pending.discard(task)
            self.metrics.realloc_failure += 1
        else:
            self.metrics.lp_failed_runtime += 1
            self.metrics.count_type(task.task_type, "lp_failed_runtime")
        self._kick(dev)
        self._kick_all()
        self._reschedule(dev)

    # -- decisions --------------------------------------------------------- #
    def decide_hp(self, task: Task, now: float) -> Decision:
        dev = self.devices[task.source_device]
        # Preemption: if starting the HP task would oversubscribe the device,
        # evict the running LP task with the farthest deadline (work lost) —
        # the same shared victim-scoring rule the calendar scheduler ranks
        # its conflict candidates with (core/victims.py).
        preempted: list[Task] = []
        if self.preemption and dev.demand + 1 > dev.capacity:
            victims = [t for t in dev.running if t.priority == Priority.LOW]
            if victims:
                victim = select_victim(victims, "farthest_deadline")
                self._preempt(dev, victim)
                preempted.append(victim)
        self._start(dev, task, cores=1)
        return Decision(DecisionStatus.ADMITTED, preempted=preempted)

    def decide_lp(self, request: LowPriorityRequest, now: float) -> Decision:
        for t in request.tasks:
            if self.central:
                self.global_queue.append(t)
            else:
                self.devices[request.source_device].queue.append(t)
        self._kick_all()
        return Decision(DecisionStatus.DEFERRED)

    # -- preemption -------------------------------------------------------- #
    def _preempt(self, dev: _WSDevice, victim: Task) -> None:
        self._advance(dev)
        run = dev.running.pop(victim)
        self._committed[dev.idx] -= run.cores
        victim.state = TaskState.PREEMPTED
        victim.preempt_count += 1
        m = self.metrics
        m.preemptions += 1
        m.preempted_by_cores[run.cores] += 1
        self._preempt_pending.add(victim)
        # re-queue for re-stealing (the workstealer's "reallocation");
        # all partial work is lost.
        if self.central:
            self.global_queue.appendleft(victim)
        else:
            self.devices[victim.source_device].queue.appendleft(victim)
        self._reschedule(dev)

    # -- completion -------------------------------------------------------- #
    def _complete(self, dev: _WSDevice, task: Task) -> None:
        late = self.host.q.now > task.deadline + 1e-9
        self.host.task_finished(task, late)
        # A finished task leaves preempt-pending either way: an on-time
        # finish is a reallocation success, a late one already lands in
        # lp_failed_runtime (leaving it pending would double-count it as a
        # realloc_failure at finalize).
        if task.priority == Priority.LOW and task in self._preempt_pending:
            self._preempt_pending.discard(task)
            if not late:
                self.metrics.realloc_success += 1

    # -- stealing ---------------------------------------------------------- #
    def _kick_all(self) -> None:
        # One vectorized pass over the committed-cores vector: only devices
        # with at least two uncommitted cores can steal, and ``_kick`` is a
        # complete no-op for every other device, so the filter is exact.
        devices = self.devices
        for i in np.flatnonzero(self._committed + 2 <= self._cap_arr):
            self._kick(devices[int(i)])

    def _kick(self, dev: _WSDevice) -> None:
        host, m = self.host, self.metrics
        # Steal while there are >= 2 uncommitted cores (running + in-flight,
        # HP included); stealing is myopic (grab 4 cores when fully idle,
        # else 2) and rash (no completion-feasibility check).
        while dev.committed + 2 <= dev.capacity:
            task, delay = self._acquire(dev)
            if task is None:
                break
            # Myopic core choice from the task's own benchmark profile:
            # max config when fully idle, min config otherwise (the paper's
            # (2, 4) world picks 4 / 2 exactly as before).
            opts = self.net.lp_core_options_for(task.task_type)
            cores = opts[-1] if dev.committed == 0 else opts[0]
            # Rash (paper §8): stealers start tasks with no *completion*
            # feasibility check — a task started with 5 s to its deadline
            # burns cores until the deadline kill. Only tasks already past
            # their deadline are dropped at steal time.
            if host.q.now + delay > task.deadline:
                task.state = TaskState.FAILED
                if task in self._preempt_pending:
                    self._preempt_pending.discard(task)
                    m.realloc_failure += 1
                else:
                    m.lp_failed_alloc += 1
                    m.count_type(task.task_type, "lp_failed_alloc")
                continue
            host.lp_started(task, cores, dev.idx != task.source_device)
            if delay > 0:
                dev.inflight += cores
                self._committed[dev.idx] += cores

                def arrive(d=dev, t=task, c=cores) -> None:
                    d.inflight -= c
                    self._committed[d.idx] -= c
                    self._start(d, t, c)

                host.q.push(host.q.now + delay, arrive)
            else:
                self._start(dev, task, cores)
        if (
            not self.central
            and dev.committed + 2 <= dev.capacity
            and dev.idx not in self._polling
            and any(d.queue for d in self.devices)
        ):
            # decentralised: retry polling while idle
            self._polling.add(dev.idx)

            def poll_again() -> None:
                self._polling.discard(dev.idx)
                self._kick(dev)

            host.q.push(host.q.now + 0.25, poll_again)

    def _acquire(self, dev: _WSDevice) -> tuple[Optional[Task], float]:
        net = self.net
        poll = 2 * net.slot(net.msg.state_update)
        if self.central:
            if self.global_queue:
                task = self.global_queue.popleft()
                delay = poll + (
                    net.input_transfer_slot(task.task_type)
                    if task.source_device != dev.idx
                    else 0.0
                )
                return task, delay
            return None, 0.0
        # decentralised: own queue first, then random polling order
        if dev.queue:
            return dev.queue.popleft(), 0.0
        order = [d for d in self.devices if d is not dev]
        self.host.rng.shuffle(order)
        delay = 0.0
        for other in order:
            delay += poll
            if other.queue:
                task = other.queue.popleft()
                return task, delay + net.input_transfer_slot(task.task_type)
        return None, delay

    def finalize(self, now: float) -> None:
        m = self.metrics
        # Victims still awaiting a re-steal: their reallocation never
        # happened.  Mark them terminal here (they also sit in a queue
        # below, which must NOT count them again into lp_failed_alloc).
        # Sorted by task id: set order over Tasks is an implementation
        # detail (task_id value hashing); settle in submission order.
        for task in sorted(self._preempt_pending, key=lambda t: t.task_id):
            task.state = TaskState.FAILED
            m.realloc_failure += 1
        self._preempt_pending.clear()
        for q in [self.global_queue] + [d.queue for d in self.devices]:
            for task in q:
                if task.state == TaskState.PENDING:
                    task.state = TaskState.FAILED
                    m.lp_failed_alloc += 1
                    m.count_type(task.task_type, "lp_failed_alloc")


@register_policy("central_ws")
class CentralWorkstealingPolicy(WorkstealingPolicy):
    """Centralised workstealer: one global job queue at the controller."""

    def __init__(self, n_devices: int, net: NetworkConfig, **kwargs) -> None:
        kwargs.pop("central", None)
        super().__init__(n_devices, net, central=True, **kwargs)


@register_policy("decentral_ws")
class DecentralWorkstealingPolicy(WorkstealingPolicy):
    """Decentralised workstealer: per-device queues, random polling."""

    def __init__(self, n_devices: int, net: NetworkConfig, **kwargs) -> None:
        kwargs.pop("central", None)
        super().__init__(n_devices, net, central=False, **kwargs)
