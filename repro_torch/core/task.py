"""Task, request and frame abstractions for the three-stage pipeline.

The paper (§3) considers a three-stage waste-classification pipeline:
  stage 1: object detection (constant overhead, always local, not scheduled)
  stage 2: low-complexity classifier  -> HIGH priority, local-only, 1 core
  stage 3: set of 1..4 high-complexity DNN tasks -> LOW priority, offloadable,
           horizontally partitioned over 2 or 4 cores.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Optional

_task_ids = itertools.count()
_request_ids = itertools.count()


def reset_id_counters() -> None:
    """Reset global id counters (between experiment runs, for determinism)."""
    global _task_ids, _request_ids
    _task_ids = itertools.count()
    _request_ids = itertools.count()


class Priority(enum.IntEnum):
    HIGH = 0   # stage-2 low-complexity classifier
    LOW = 1    # stage-3 high-complexity DNN


class TaskState(enum.Enum):
    PENDING = "pending"          # created, not yet allocated
    ALLOCATED = "allocated"      # controller reserved resources
    RUNNING = "running"          # execution started on a device
    COMPLETED = "completed"      # finished within its deadline
    PREEMPTED = "preempted"      # evicted by a high-priority task
    FAILED = "failed"            # could not be (re)allocated / missed deadline
    VIOLATED = "violated"        # overran its reserved slot at runtime


@dataclass
class Task:
    """A single schedulable unit (stage-2 classifier or one stage-3 DNN)."""

    priority: Priority
    source_device: int
    deadline: float
    frame_id: int
    request_id: Optional[int] = None       # LP tasks belong to a request set
    # Workload-profile key (core/profiles.py): which benchmark table sizes
    # this task's slots.  None = the workload spec's default profile (the
    # paper's single-model pipeline needs no annotations).
    task_type: Optional[str] = None
    task_id: int = field(default_factory=lambda: next(_task_ids))
    state: TaskState = TaskState.PENDING
    # Variant-ladder rung (core/profiles.py, DESIGN.md §17): index into the
    # task type's degradation ladder.  0 = the full-accuracy base profile
    # (every closed-workload golden path); a positive index resolves through
    # TaskProfile.variant_profile to a cheaper rung, and pins the
    # scheduler's core-upgrade pass off.  For ladder-free profiles a
    # positive index keeps the base exec stats — exactly the legacy one-bit
    # degrade semantics.
    variant: int = 0
    # Filled in by the scheduler on allocation:
    device: Optional[int] = None
    cores: int = 0
    t_start: float = 0.0
    t_end: float = 0.0
    offloaded: bool = False
    preempt_count: int = 0
    created_at: float = 0.0

    @property
    def is_high(self) -> bool:
        return self.priority == Priority.HIGH

    @property
    def degraded(self) -> bool:
        """Deprecated one-bit view of the variant ladder: any rung below
        variant 0 counts as degraded (pre-ladder callers keep working)."""
        return self.variant > 0

    @degraded.setter
    def degraded(self, flag: bool) -> None:
        if flag:
            self.variant = max(self.variant, 1)
        else:
            self.variant = 0

    def __hash__(self) -> int:
        return self.task_id

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Task) and other.task_id == self.task_id


@dataclass
class LowPriorityRequest:
    """A set of stage-3 DNN tasks spawned by one completed stage-2 task.

    The request only counts as complete when *every* task in the set completes
    before the request deadline (paper §4, §6 'set completion').
    """

    source_device: int
    deadline: float
    frame_id: int
    n_tasks: int
    created_at: float = 0.0
    task_type: Optional[str] = None        # workload-profile key (see Task)
    request_id: int = field(default_factory=lambda: next(_request_ids))
    tasks: list[Task] = field(default_factory=list)

    def make_tasks(self) -> list[Task]:
        self.tasks = [
            Task(
                priority=Priority.LOW,
                source_device=self.source_device,
                deadline=self.deadline,
                frame_id=self.frame_id,
                request_id=self.request_id,
                task_type=self.task_type,
                created_at=self.created_at,
            )
            for _ in range(self.n_tasks)
        ]
        return self.tasks

    @property
    def completed(self) -> bool:
        return bool(self.tasks) and all(
            t.state == TaskState.COMPLETED for t in self.tasks
        )


@dataclass
class Frame:
    """One sampled conveyor-belt frame on one device.

    trace_value semantics (paper §5):
      -1        no object detected (nothing scheduled; frame trivially complete)
       0        HP task only
       1..4     HP task, then an LP request with that many DNN tasks
    """

    device: int
    gen_time: float
    trace_value: int
    frame_id: int
    deadline: float
    task_type: Optional[str] = None        # workload-profile key (see Task)
    hp_task: Optional[Task] = None
    lp_request: Optional[LowPriorityRequest] = None

    @property
    def completed(self) -> bool:
        if self.trace_value == -1:
            return True
        if self.hp_task is None or self.hp_task.state != TaskState.COMPLETED:
            return False
        if self.trace_value == 0:
            return True
        return self.lp_request is not None and self.lp_request.completed
