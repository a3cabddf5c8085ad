"""Preemption-aware serving engine — the paper's scheduler driving real
PyTorch compute.

Port of the JAX package's ``serving/engine.py``.  Mapping:
  edge device (4 cores)      -> device slice with C shard-units
  HP stage-2 classifier      -> interactive prefill request (latency SLO)
  LP stage-3 DNN set         -> background batch-decode jobs (offloadable)
  2-/4-core partitioning     -> 2-/4-way model-parallel degree
  shared 802.11n link        -> inter-slice interconnect (token/KV transfer)
  preempt + reallocate       -> evict decode job between steps, requeue

Two preemption modes:
  lose_work=True   paper-faithful: a preempted job loses all progress.
  lose_work=False  beyond-paper: decode state (KV cache) stays resident in
                   device memory, so a resumed job continues from its last
                   token.

The engine runs in *virtual time* driven by the time-slotted calendars of
the scheduler core, while token generation is real compute on ``device``
(a CUDA card unless the caller asks for ``"cpu"``): scheduling decisions
and deadline outcomes come from the calendar; logits come from the model.

Scheduling is pluggable: the ``policy`` argument resolves through the
policy registry, so the engine drives any *slot-based* registered
discipline through the same ``PolicyDispatcher`` admission/execution loop
as the simulator.  Execution-driving policies are rejected.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..core.metrics import Metrics
from ..core.network import NetworkConfig
from ..core.policy import DispatchClient, PolicyDispatcher, create_policy
from ..core.profiles import WorkloadSpec
from ..core.task import LowPriorityRequest, Priority, Task, TaskState
from ..device import resolve_device
from ..models.config import ModelConfig
from ..sim.events import EventQueue
from ..training.steps import make_prefill_step, make_serve_step
from .cost_model import CostModel
from .stream import validate_submission

_rid = itertools.count()


def engine_network_config(cost: CostModel, lp_tokens: int,
                          link_gbps: float = 40.0,
                          workload: Optional[WorkloadSpec] = None,
                          ) -> NetworkConfig:
    """Build the time-slot model from measured step costs (the paper derives
    slot lengths from offline benchmarks + std-dev padding; we do the same
    from the CostModel).  The 'link' is the inter-slice interconnect; message
    sizes keep the paper's control-plane values.

    The timing model is a real :class:`WorkloadSpec` (built from ``cost``
    via ``WorkloadSpec.from_cost_model`` unless an explicit multi-model
    ``workload`` is given); the default profile's numbers are mirrored into
    the legacy scalar fields for direct readers."""
    spec = workload if workload is not None else WorkloadSpec.from_cost_model(
        cost, lp_tokens=lp_tokens, name="serve")
    prof = spec.profile()
    degs = prof.core_options
    return NetworkConfig(
        throughput_bps=link_gbps * 1e9 / 8,
        jitter_pad_s=1e-4,
        t_hp=prof.hp_exec,
        t_lp_2core=prof.lp_exec.get(2, prof.lp_exec[degs[0]]),
        t_lp_4core=prof.lp_exec.get(4, prof.lp_exec[degs[-1]]),
        hp_pad_s=prof.hp_pad,
        lp_pad_s=prof.lp_pad[degs[0]],
        t_object_detect=0.0,
        frame_period=max(prof.lp_exec[degs[0]] * 1.1, 1e-3),
        hp_deadline_slack=prof.hp_deadline_slack,
        workload=spec,
    )


@dataclass(eq=False)                      # identity equality: the prompt is
class ServeRequest:                       # a tensor (dataclass __eq__
                                          # would compare it elementwise)
    prompt: Any                          # [1, T] int tensor
    max_new_tokens: int
    priority: Priority
    deadline: float                      # virtual-time deadline
    home_slice: int
    # Workload-profile key (core/profiles.py): which model profile sizes
    # this request's slots.  None = the engine workload's default profile.
    task_type: Optional[str] = None
    arrival: float = 0.0
    rid: int = field(default_factory=lambda: next(_rid))
    # results
    tokens_out: list[int] = field(default_factory=list)
    state: str = "pending"               # pending|running|done|failed|preempted
    completed_at: float = -1.0
    n_preemptions: int = 0
    task: Optional[Task] = None


class _ServingClient(DispatchClient):
    """Dispatcher hooks for the engine (real compute, request bookkeeping)."""

    def __init__(self, eng: "PreemptiveServingEngine") -> None:
        self.eng = eng

    def on_start(self, task: Task) -> None:
        self.eng._run_compute(task)

    def on_hp_complete(self, task: Task) -> None:
        self.eng._finish_request(task)

    def on_lp_complete(self, task: Task) -> None:
        self.eng.metrics.lp_requests_completed += 1
        self.eng._finish_request(task)

    def on_preempt(self, task: Task) -> None:
        eng = self.eng
        req = eng._by_task.get(task)
        if req is None:
            return
        req.n_preemptions += 1
        req.state = "preempted"
        if eng.lose_work:
            eng._decode_state.pop(req.rid, None)
            req.tokens_out = []

    def on_admit_fail(self, task: Task) -> None:
        eng = self.eng
        req = eng._by_task.get(task)
        if req is None:
            return
        req.state = "failed"
        eng.done.append(req)

    def on_device_lost(self, task: Task) -> None:
        # The slice holding this request's decode state died: unlike a
        # preemption under lose_work=False, the resident KV cache is gone
        # with the hardware, so a recovered orphan always restarts.
        eng = self.eng
        req = eng._by_task.get(task)
        if req is None:
            return
        req.n_preemptions += 1
        req.state = "preempted"
        eng._decode_state.pop(req.rid, None)
        req.tokens_out = []


class PreemptiveServingEngine:
    """Priority/deadline/preemption-aware engine over N slices."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        cost: CostModel,
        *,
        device: str | torch.device = "cuda",
        n_slices: int = 4,
        units_per_slice: int = 4,
        preemption: bool = True,
        lose_work: bool = True,
        cache_len: int = 256,
        net: Optional[NetworkConfig] = None,
        victim_policy: str = "farthest_deadline",
        policy: str = "scheduler",
    ) -> None:
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine runs "
                f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.cost = cost
        self.cache_len = cache_len
        self.lose_work = lose_work
        self.q = EventQueue()
        self.metrics = Metrics("serving")
        self.net = net or NetworkConfig()
        self.policy = create_policy(
            policy,
            n_devices=n_slices,
            net=self.net,
            capacity=units_per_slice,
            preemption=preemption,
            victim_policy=victim_policy,
            metrics=self.metrics,
        )
        if self.policy.drives_execution:
            raise ValueError(
                f"policy {policy!r} drives its own execution model; the "
                "serving engine requires a slot-based policy (reserved "
                "[t_start, t_end) windows to pin real compute to)"
            )
        # slice calendars (tests and cost probes read occupancy off this)
        self.state = getattr(self.policy, "state", None)
        self.dispatcher = PolicyDispatcher(
            self.policy, self.q, self.net, self.metrics,
            client=_ServingClient(self), exact_slots=True,
        )
        self._prefill = make_prefill_step(cfg, cache_len, device=self.device)
        self._serve = make_serve_step(cfg, device=self.device)
        self._by_task: dict[Task, ServeRequest] = {}
        self._decode_state: dict[int, tuple] = {}   # rid -> (caches, last, pos)
        self.done: list[ServeRequest] = []

    # ------------------------------------------------------------------ #
    # Submission                                                          #
    # ------------------------------------------------------------------ #
    def submit(self, req: ServeRequest) -> None:
        validate_submission(
            priority=req.priority, deadline=req.deadline, now=self.q.now,
            max_new_tokens=req.max_new_tokens, task_type=req.task_type,
            spec=self.net.spec)
        req.arrival = self.q.now
        self.q.push(self.q.now, lambda: self._admit(req))

    def submit_batch(self, reqs: list[ServeRequest]) -> None:
        """Admit a burst of requests at the same virtual instant.

        LP requests go through the policy's batch decision (one sweep across
        the whole burst); HP requests keep per-request admission, since each
        may preempt and must observe the link state its predecessors left
        behind.
        """
        lp = [r for r in reqs if r.priority == Priority.LOW]
        for r in reqs:
            if r.priority == Priority.HIGH:
                self.submit(r)
        if lp:
            for r in lp:
                validate_submission(
                    priority=r.priority, deadline=r.deadline, now=self.q.now,
                    max_new_tokens=r.max_new_tokens, task_type=r.task_type,
                    spec=self.net.spec)
                r.arrival = self.q.now
            self.q.push(self.q.now, lambda: self._admit_lp_batch(lp))

    def _make_lp(self, req: ServeRequest, now: float) -> LowPriorityRequest:
        """Wrap a serve request as a one-task LP request and register it."""
        self.metrics.lp_generated += 1
        self.metrics.lp_requests_total += 1
        lp = LowPriorityRequest(
            source_device=req.home_slice, deadline=req.deadline,
            frame_id=req.rid, n_tasks=1, task_type=req.task_type,
            created_at=now)
        lp.make_tasks()
        task = lp.tasks[0]
        self._by_task[task] = req
        req.task = task
        return lp

    def _admit_lp_batch(self, reqs: list[ServeRequest]) -> None:
        now = self.q.now
        lps = [self._make_lp(req, now) for req in reqs]
        self.dispatcher.submit_lp_batch(lps)

    def _admit(self, req: ServeRequest) -> None:
        now = self.q.now
        if req.priority == Priority.HIGH:
            task = Task(priority=req.priority, source_device=req.home_slice,
                        deadline=req.deadline, frame_id=req.rid,
                        task_type=req.task_type)
            req.task = task
            self._by_task[task] = req
            self.metrics.hp_generated += 1
            self.dispatcher.submit_hp(task)
        else:
            self.dispatcher.submit_lp(self._make_lp(req, now))

    # ------------------------------------------------------------------ #
    # Execution (real compute at virtual-time slot boundaries)            #
    # ------------------------------------------------------------------ #
    def _run_compute(self, task: Task) -> None:
        """The reserved slot began: run the request's actual compute."""
        req = self._by_task[task]
        req.state = "running"
        if req.priority == Priority.HIGH:
            nxt, _ = self._prefill(self.params, {"tokens": req.prompt})
            req.tokens_out = [int(nxt[0])]
        else:
            # run prefill now (or resume), decode tokens as the slot elapses
            if req.rid in self._decode_state and not self.lose_work:
                caches, last, pos = self._decode_state[req.rid]
            else:
                req.tokens_out = []
                nxt, caches = self._prefill(self.params,
                                            {"tokens": req.prompt})
                last = nxt[:, None]
                pos = req.prompt.shape[1]
                req.tokens_out.append(int(nxt[0]))
            remaining = req.max_new_tokens - len(req.tokens_out)
            for _ in range(remaining):
                last, caches = self._serve(self.params, caches, last, pos)
                req.tokens_out.append(int(last[0, 0]))
                pos += 1
            self._decode_state[req.rid] = (caches, last, pos)

    def _finish_request(self, task: Task) -> None:
        req = self._by_task[task]
        req.state = "done"
        req.completed_at = self.q.now
        self._decode_state.pop(req.rid, None)
        self.done.append(req)

    # ------------------------------------------------------------------ #
    # Slice churn                                                         #
    # ------------------------------------------------------------------ #
    def fail_slice(self, idx: int):
        """A slice died mid-run: its in-flight requests orphan, lose their
        resident decode state, and recover elsewhere (or fail)."""
        return self.dispatcher.device_lost(idx)

    def drain_slice(self, idx: int) -> None:
        self.dispatcher.device_drained(idx)

    def rejoin_slice(self, idx: int) -> None:
        self.dispatcher.device_rejoined(idx)

    # ------------------------------------------------------------------ #
    def run(self, until: Optional[float] = None) -> Metrics:
        self.q.run(until)
        for req in self._by_task.values():
            if req.state in ("pending", "preempted", "running") and \
                    req not in self.done:
                if req.task is not None and \
                        req.task.state == TaskState.FAILED:
                    req.state = "failed"
        return self.metrics
