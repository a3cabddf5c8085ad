"""Communication model: message sizes, throughput and time-slot padding.

All constants are the paper's benchmarked values (§5):
  high-priority allocation message : 700 B
  low-priority allocation message  : 2250 B
  state update                     : 550 B
  preemption message               : 550 B
  input (image) transfer           : 21500 B
Throughput was measured with iperf3 at system start-up (~16.3 MB/s with
preemption run, ~18.78 MB/s without); communication slots are padded with the
measured network jitter, processing slots with the benchmark std-dev (§3).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Optional

# Device lifecycle states (churn plane, DESIGN.md §16).  The states and the
# fail_device / drain_device / rejoin_device mutation API live on the
# calendar layer's NetworkState (core/calendar.py), next to the calendars
# they clear; re-exported here because this module is the network model's
# public face.
from .calendar import DeviceLifecycle, NetworkState  # noqa: F401
from .profiles import PAPER_TYPE, TaskProfile, WorkloadSpec, get_workload


@dataclass(frozen=True)
class MessageSizes:
    hp_alloc: int = 700
    lp_alloc: int = 2250
    state_update: int = 550
    preempt: int = 550
    input_transfer: int = 21500


@dataclass(frozen=True)
class NetworkConfig:
    """Timing model shared by the scheduler and the simulator."""

    throughput_bps: float = 16.3e6          # bytes/s, measured at start-up
    jitter_pad_s: float = 0.002             # comm slot padding (network jitter)
    msg: MessageSizes = field(default_factory=MessageSizes)

    # Benchmarked processing times on the RPi2B (§5) and their slot padding
    # (std-dev of the offline benchmark runs, §3).
    t_object_detect: float = 0.100          # stage 1, constant overhead
    t_hp: float = 0.980                     # stage 2, 1 core
    t_lp_2core: float = 16.862              # stage 3, 2-core horizontal split
    t_lp_4core: float = 11.611              # stage 3, 4-core horizontal split
    hp_pad_s: float = 0.050
    lp_pad_s: float = 0.400

    # Pipeline cadence (§5): derived from the minimum viable end-to-end time.
    frame_period: float = 18.86
    # HP deadline slack beyond detect+proc (paper: stage-2 deadline ~1 s;
    # must cover allocation + preemption-selection latency, §6.3).
    hp_deadline_slack: float = 0.45

    # Controller job-queue latencies (paper §3.3: blocking sequential request
    # processing; §6.3: HP alloc ~10 ms, LP alloc ~150 ms, preemption +
    # reallocation pushing HP paths toward ~300-400 ms under load).
    ctrl_hp_alloc_lat: float = 0.010
    ctrl_hp_preempt_extra: float = 0.040
    ctrl_lp_alloc_lat: float = 0.150
    ctrl_realloc_lat: float = 0.250

    # Contention-induced slowdown (paper §8 reports the 11.611 s benchmarked
    # 4-core task averaging ~14.5 s under middleware + concurrent-DNN load).
    # The paper's own 18.86 s frame period is derived so a 2-core task barely
    # fits its window, so the benchmarked times must already include typical
    # co-location; we model only *additional* contention, mildly:
    # exec = base * (1 + coef * other_busy_cores/capacity).
    lp_contention_coef: float = 0.05
    hp_contention_coef: float = 0.03

    # Heterogeneous workloads (core/profiles.py): a WorkloadSpec mapping task
    # types to per-(type x core config) benchmark profiles.  None (the
    # default) derives a single-profile spec from the paper constants above —
    # bit-for-bit the seed's timing model.
    workload: Optional[WorkloadSpec] = None

    @cached_property
    def spec(self) -> WorkloadSpec:
        """The active workload spec (derived from the paper constants when
        no explicit ``workload`` was given)."""
        if self.workload is not None:
            return self.workload
        return WorkloadSpec.from_paper_constants(
            t_hp=self.t_hp,
            hp_pad_s=self.hp_pad_s,
            t_lp_2core=self.t_lp_2core,
            t_lp_4core=self.t_lp_4core,
            lp_pad_s=self.lp_pad_s,
            input_bytes=self.msg.input_transfer,
            output_bytes=self.msg.state_update,
            hp_deadline_slack=self.hp_deadline_slack,
        )

    def profile(self, task_type: Optional[str] = None) -> TaskProfile:
        """The benchmark profile for a task type (None -> default type)."""
        return self.spec.profile(task_type)

    def profile_for(self, task) -> TaskProfile:
        """The profile a task actually runs at: its type's ladder rung
        selected by ``task.variant`` (DESIGN.md §17).  Variant 0 — every
        golden path — resolves to the base profile bit-identically."""
        prof = self.spec.profile(task.task_type)
        return prof.variant_profile(task.variant) if task.variant else prof

    def slot(self, n_bytes: int) -> float:
        """Duration of a padded link time-slot for an n-byte message."""
        return n_bytes / self.throughput_bps + self.jitter_pad_s

    def input_transfer_slot(self, task_type: Optional[str] = None) -> float:
        """Padded link-slot duration of one offload input transfer."""
        return self.slot(self.profile(task_type).input_bytes)

    def hp_proc_time(self, task_type: Optional[str] = None) -> float:
        return self.profile(task_type).hp_exec

    def lp_proc_time(self, cores: int,
                     task_type: Optional[str] = None) -> float:
        return self.profile(task_type).lp_proc_time(cores)

    def lp_slot_time(self, cores: int,
                     task_type: Optional[str] = None) -> float:
        return self.profile(task_type).lp_slot_time(cores)

    @property
    def hp_slot_time(self) -> float:
        return self.profile().hp_slot_time

    def hp_slot_time_for(self, task_type: Optional[str] = None) -> float:
        return self.profile(task_type).hp_slot_time

    @property
    def lp_core_options(self) -> tuple[int, ...]:
        """Viable horizontal-partitioning configs, minimum first (§3.2)."""
        return self.profile().core_options

    def lp_core_options_for(
        self, task_type: Optional[str] = None
    ) -> tuple[int, ...]:
        return self.profile(task_type).core_options

    def hp_deadline(self, request_time: float,
                    task_type: Optional[str] = None) -> float:
        return self.profile(task_type).hp_deadline(request_time)


def resolve_network(net: Optional[NetworkConfig],
                    workload_name: str) -> NetworkConfig:
    """The one place a runtime reconciles an (optional) explicit
    ``NetworkConfig`` with a scenario's named workload.

    * ``net is None``: build the config for the workload — ``"paper"``
      derives the spec from the config's own constants (so custom constants
      keep working), any other name resolves through the registry.
    * explicit ``net``: it wins (its constants AND its spec), but it must be
      able to answer every task type the named workload will generate —
      a mixed scenario handed a single-model net fails HERE with a clear
      error instead of deep inside the event loop when the first typed
      task asks for its profile.
    """
    if net is None:
        spec = (None if workload_name == PAPER_TYPE
                else get_workload(workload_name))
        return NetworkConfig(workload=spec)
    if workload_name != PAPER_TYPE:
        want = get_workload(workload_name)
        missing = [t for t in want.task_types if t not in net.spec.profiles]
        if missing:
            raise ValueError(
                f"explicit NetworkConfig carries workload "
                f"{net.spec.name!r}, which lacks task type(s) {missing} "
                f"required by scenario workload {workload_name!r}; pass "
                f"NetworkConfig(workload=get_workload({workload_name!r})) "
                "or drop the explicit net"
            )
    return net
