# The paper's primary contribution — implement the SYSTEM here
# (scheduler, optimizer, data path, serving loop, etc.) in the
# host framework. Add sibling subpackages for substrates.
from .calendar import DeviceCalendar, LinkCalendar, NetworkState, Reservation
from .metrics import Metrics
from .network import MessageSizes, NetworkConfig
from .profiles import (
    PAPER_TYPE,
    TaskProfile,
    WorkloadSpec,
    get_workload,
    register_workload,
    registered_workloads,
)
from .policy import (
    Decision,
    DecisionStatus,
    PolicyDispatcher,
    SchedulingPolicy,
    create_policy,
    register_policy,
    registered_policies,
)
from .scheduler import (
    Allocation,
    HPResult,
    LPResult,
    PreemptionAwareScheduler,
    VICTIM_POLICIES,
)
from .task import Frame, LowPriorityRequest, Priority, Task, TaskState

__all__ = [
    "Allocation",
    "Decision",
    "DecisionStatus",
    "DeviceCalendar",
    "Frame",
    "HPResult",
    "LinkCalendar",
    "LowPriorityRequest",
    "LPResult",
    "MessageSizes",
    "Metrics",
    "NetworkConfig",
    "NetworkState",
    "PAPER_TYPE",
    "PolicyDispatcher",
    "PreemptionAwareScheduler",
    "Priority",
    "Reservation",
    "SchedulingPolicy",
    "Task",
    "TaskProfile",
    "TaskState",
    "VICTIM_POLICIES",
    "WorkloadSpec",
    "create_policy",
    "get_workload",
    "register_policy",
    "register_workload",
    "registered_policies",
    "registered_workloads",
]
