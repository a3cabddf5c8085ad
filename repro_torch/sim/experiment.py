"""Discrete-event reproduction of the paper's RPi2B testbed experiments (§5/§6).

One frame-generation runtime drives ANY scheduling discipline registered in
the policy registry (``core/policy.py``) — the paper's preemption-aware
scheduler, both workstealer baselines, and the beyond-paper ``edf_only`` /
``no_offload`` baselines — each with and without the preemption mechanism.
``ScenarioConfig.algorithm`` resolves through the registry, so adding a new
discipline requires no edits to this module.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from ..core.metrics import Metrics
from ..core.network import NetworkConfig, resolve_network
from ..core.policy import DispatchClient, PolicyDispatcher, create_policy, \
    registered_policies
from ..core.profiles import PAPER_TYPE, validate_workload_name
from ..core.scheduler import VICTIM_POLICIES
from ..core.task import (
    Frame,
    LowPriorityRequest,
    Priority,
    Task,
    TaskState,
    reset_id_counters,
)
from .events import EventQueue
from .traces import TRACE_FAMILIES, TraceConfig, generate_trace, \
    generate_type_trace, validate_trace_name


@dataclass(frozen=True)
class ScenarioConfig:
    name: str
    trace: str                       # "uniform" | "weighted_1".."weighted_4" | "ratio_P"
    algorithm: str                   # any name in core.policy.registered_policies()
    preemption: bool
    n_frames: int = 1296
    n_devices: int = 4
    seed: int = 0
    exec_noise: bool = True
    hp_noise_sigma: float = 0.02
    lp_noise_sigma: float = 0.20
    # "farthest_deadline" (paper §4) | "weakest_set" (paper §8 proposal,
    # beyond-paper — see EXPERIMENTS.md §Beyond-paper scheduling)
    victim_policy: str = "farthest_deadline"
    # Controller-side LP batching (beyond-paper, DESIGN.md §4.3): LP requests
    # arriving within this window are admitted through ONE batch sweep
    # (`decide_lp_batch`).  0 = the paper's per-request path.
    lp_batch_window: float = 0.0
    # Workload spec name (core/profiles.py registry, DESIGN.md §10):
    # "paper" is the seed's single-model pipeline; "mixed_edge" interleaves
    # three model profiles with distinct benchmarks and deadlines.
    workload: str = PAPER_TYPE
    # Degrade-before-reject admission (DESIGN.md §17): on LP infeasibility
    # the scheduler retries down the task type's variant ladder before
    # emitting a rejection.  Off by default so every committed golden stays
    # bit-identical; only the calendar scheduler honours it (edf_only and
    # the workstealers absorb and ignore the knob).
    degrade: bool = False

    def __post_init__(self) -> None:
        if self.algorithm not in registered_policies():
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; registered policies: "
                + ", ".join(registered_policies())
            )
        validate_trace_name(self.trace)
        validate_workload_name(self.workload)
        if self.victim_policy not in VICTIM_POLICIES:
            raise ValueError(
                f"unknown victim_policy {self.victim_policy!r}; expected one "
                "of: " + ", ".join(VICTIM_POLICIES)
            )


# The paper's evaluated scenarios (Table 1 legend).
SCENARIOS: dict[str, ScenarioConfig] = {
    "UPS": ScenarioConfig("UPS", "uniform", "scheduler", True),
    "UNPS": ScenarioConfig("UNPS", "uniform", "scheduler", False),
    "WPS_1": ScenarioConfig("WPS_1", "weighted_1", "scheduler", True),
    "WPS_2": ScenarioConfig("WPS_2", "weighted_2", "scheduler", True),
    "WPS_3": ScenarioConfig("WPS_3", "weighted_3", "scheduler", True),
    "WPS_4": ScenarioConfig("WPS_4", "weighted_4", "scheduler", True),
    "WNPS_4": ScenarioConfig("WNPS_4", "weighted_4", "scheduler", False),
    "DPW": ScenarioConfig("DPW", "weighted_4", "decentral_ws", True),
    "DNPW": ScenarioConfig("DNPW", "weighted_4", "decentral_ws", False),
    "CPW": ScenarioConfig("CPW", "weighted_4", "central_ws", True),
    "CNPW": ScenarioConfig("CNPW", "weighted_4", "central_ws", False),
    # beyond-paper: the paper's §8 set-aware victim-selection proposal
    "UPS_SET": ScenarioConfig("UPS_SET", "uniform", "scheduler", True,
                              victim_policy="weakest_set"),
    "WPS_4_SET": ScenarioConfig("WPS_4_SET", "weighted_4", "scheduler", True,
                                victim_policy="weakest_set"),
    "WPS_3_SET": ScenarioConfig("WPS_3_SET", "weighted_3", "scheduler", True,
                                victim_policy="weakest_set"),
}

# Beyond-paper: heterogeneous fleets (core/profiles.py "mixed_edge" — the
# paper's model interleaved with a light mobile classifier and a heavy
# detection transformer, each with its own benchmark table, transfer sizes
# and LP deadline).  Kept out of ``SCENARIOS`` so the paper's Table-1 set
# stays exactly the published legend; golden-replayed all the same.
MIXED_SCENARIOS: dict[str, ScenarioConfig] = {
    "MPS": ScenarioConfig("MPS", "uniform", "scheduler", True,
                          workload="mixed_edge"),
    "MNPS": ScenarioConfig("MNPS", "uniform", "scheduler", False,
                           workload="mixed_edge"),
    "MPS_W4": ScenarioConfig("MPS_W4", "weighted_4", "scheduler", True,
                             workload="mixed_edge"),
}


class _SimClient(DispatchClient):
    """Dispatcher hooks for the discrete-event sim (noise model, frames)."""

    def __init__(self, rt: "Runtime") -> None:
        self.rt = rt

    def exec_time(self, task: Task, busy_frac: float) -> float:
        return self.rt.exec_time(task, busy_frac)

    def on_hp_complete(self, task: Task) -> None:
        frame = self.rt.frames_by_hp[task]
        if frame.trace_value >= 1:
            self.rt.issue_lp_request(frame)


class Runtime:
    """Frame generation + metric finalisation shared by all policies."""

    def __init__(self, cfg: ScenarioConfig, net: Optional[NetworkConfig] = None):
        self.cfg = cfg
        # An explicit net wins but must cover the workload's task types
        # (resolve_network raises early on a mismatch).
        self.net = resolve_network(net, cfg.workload)
        self.q = EventQueue()
        self.metrics = Metrics(cfg.name)
        self.rng = random.Random(cfg.seed * 7919 + 17)
        self.frames: list[Frame] = []
        self.requests: list[LowPriorityRequest] = []
        self.frames_by_hp: dict[Task, Frame] = {}
        self.policy = create_policy(
            cfg.algorithm,
            n_devices=cfg.n_devices,
            net=self.net,
            preemption=cfg.preemption,
            victim_policy=cfg.victim_policy,
            metrics=self.metrics,
            degrade=cfg.degrade,
        )
        self.dispatcher = PolicyDispatcher(
            self.policy, self.q, self.net, self.metrics,
            client=_SimClient(self),
            lp_batch_window=cfg.lp_batch_window,
            rng=self.rng,
            exec_noise=cfg.exec_noise,
            hp_noise_sigma=cfg.hp_noise_sigma,
            lp_noise_sigma=cfg.lp_noise_sigma,
        )

    # -- execution-time noise + contention model -------------------------- #
    def exec_time(self, task: Task, busy_frac: float = 0.0) -> float:
        # profile_for resolves the task's admitted ladder rung (variant 0 =
        # the base profile, the historic behaviour for every golden run).
        prof = self.net.profile_for(task)
        if task.priority == Priority.HIGH:
            base, sigma, coef = prof.hp_exec, self.cfg.hp_noise_sigma, \
                self.net.hp_contention_coef
        else:
            base, sigma, coef = prof.lp_proc_time(task.cores), \
                self.cfg.lp_noise_sigma, self.net.lp_contention_coef
        t = base * (1.0 + coef * busy_frac)
        if self.cfg.exec_noise:
            t += self.rng.gauss(0.0, sigma)
        return max(0.05, t)

    # -- frame pipeline -------------------------------------------------- #
    def run(self) -> Metrics:
        reset_id_counters()
        trace_cfg = TraceConfig(self.cfg.trace, self.cfg.n_frames,
                                self.cfg.n_devices, self.cfg.seed)
        trace = generate_trace(trace_cfg)
        # Mixed workloads: an independent, equally deterministic draw assigns
        # each device-frame its task type (single-profile specs skip the
        # draw entirely, so the paper scenarios' random streams are
        # untouched).
        spec = self.net.spec
        types = (generate_type_trace(trace_cfg, spec.mix_weights())
                 if spec.is_mixed else None)
        period = self.net.frame_period
        # Hosts start as staggered pairs (paper §3) with random per-device offset.
        offsets = [
            self.rng.uniform(0.0, 1.0) + (period / 2 if d >= self.cfg.n_devices // 2 else 0.0)
            for d in range(self.cfg.n_devices)
        ]
        fid = 0
        for k in range(self.cfg.n_frames):
            for d in range(self.cfg.n_devices):
                t = offsets[d] + k * period
                self._spawn_frame(t, d, int(trace[k, d]), fid,
                                  None if types is None else str(types[k, d]))
                fid += 1
        self.q.run()
        return self._finalize()

    def _spawn_frame(self, t: float, device: int, value: int, fid: int,
                     task_type: Optional[str] = None) -> None:
        # Per-type LP deadline (a mixed workload's profiles carry their own
        # relative deadlines); the paper profile falls back to the frame
        # period, exactly the seed behaviour.
        prof = self.net.profile(task_type)
        rel_deadline = (prof.lp_deadline if prof.lp_deadline is not None
                        else self.net.frame_period)
        frame = Frame(device, t, value, fid, deadline=t + rel_deadline,
                      task_type=task_type)
        self.frames.append(frame)

        def gen() -> None:
            self.metrics.frames_total += 1
            if frame.trace_value == -1:
                return
            self.metrics.hp_generated += 1
            # stage 1 object detection = constant overhead before the HP request
            self.q.push(self.q.now + self.net.t_object_detect,
                        lambda: self._hp_request(frame))

        self.q.push(t, gen)

    def _hp_request(self, frame: Frame) -> None:
        now = self.q.now
        task = Task(
            priority=Priority.HIGH,
            source_device=frame.device,
            deadline=self.net.hp_deadline(now, frame.task_type),
            frame_id=frame.frame_id,
            task_type=frame.task_type,
            created_at=now,
        )
        frame.hp_task = task
        self.frames_by_hp[task] = frame
        self.dispatcher.submit_hp(task)

    def issue_lp_request(self, frame: Frame) -> None:
        """Called when a frame's HP task completes with value>=1."""
        req = LowPriorityRequest(
            source_device=frame.device,
            deadline=frame.deadline,
            frame_id=frame.frame_id,
            n_tasks=frame.trace_value,
            task_type=frame.task_type,
            created_at=self.q.now,
        )
        req.make_tasks()
        frame.lp_request = req
        self.requests.append(req)
        self.metrics.lp_generated += req.n_tasks
        self.metrics.lp_requests_total += 1
        # request message transit to the controller
        self.q.push(self.q.now + self.net.slot(self.net.msg.lp_alloc),
                    lambda: self.dispatcher.submit_lp(req))

    def _finalize(self) -> Metrics:
        m = self.metrics
        self.dispatcher.finalize()
        for frame in self.frames:
            if frame.completed:
                m.frames_completed += 1
        for req in self.requests:
            done = sum(1 for t in req.tasks if t.state == TaskState.COMPLETED)
            m.lp_request_fractions.append(done / req.n_tasks)
            if done == req.n_tasks:
                m.lp_requests_completed += 1
        return m


def run_scenario(cfg: ScenarioConfig, net: Optional[NetworkConfig] = None) -> Metrics:
    return Runtime(cfg, net).run()
