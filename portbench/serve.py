"""A serving cell: the port's ``PreemptiveServingEngine`` with the paper's
scheduler in front of real prefill and decode on the card.

Set-up makes the weights from the seed, measures the slots with the port's
``measure_cost_model`` at each prompt length of the traffic (which also
warms every shape the window uses), and builds one task type per (class,
prompt length) through the public ``TaskProfile`` / ``WorkloadSpec`` API:
an HP type's slot is its prefill, an LP type's its prefill plus its decode
steps, both padded by the measured spread, each parallel degree scaled as
the cost model scales its decode.  Deadlines are the traffic file's frozen
numbers.

The window runs whole episodes (``gen.episode``) through a fresh engine
each, back to back, until ``--seconds`` of wall time have passed (and at
least the episodes that hold the judged sample).  The end-to-end metric
is the window's own work: the prompt and generated tokens of every
request done, over the wall seconds from the window's start to the end
of its last episode.  The engine keeps virtual time, and its outcomes on
that clock (requests met, preemptions) rest on the slots the set-up
measured; they are per-layer metrics of the scheduler.

The harness relies on three private attributes of the engine, which it
wraps: ``_run_compute`` (which request a slot computes), ``_prefill`` and
``_serve`` (their caches, for the K/V rows of the judged requests only,
and the spans of a traced run).
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from . import bench, gen
from .reference import schedule as ref_schedule
from .trace import span, traced
from .weights import make_weights


# Each prompt length's slots are measured COST_TRIALS times, COST_REPS
# reps a trial (``measure_cost_model``), and the trial with the shorter
# padded prefill and decode step is kept.
COST_TRIALS = 2
COST_REPS = 5


def build_spec(traffic: dict, costs: dict):
    """One TaskProfile per (class, prompt length) from the measured costs
    (``costs[length]``: the port's CostModel at that prompt length)."""
    from repro_torch.core.profiles import TaskProfile, WorkloadSpec
    profiles = {}
    for cls in traffic["classes"]:
        k = cls["new_tokens"]
        for length in cls["prompt_lens"]:
            c = costs[length]
            pre, d2 = c.prefill[1], c.decode[2]
            scale = {d: c.decode[d].mean_s / d2.mean_s for d in c.decode}
            lp_mean = pre.mean_s + (k - 1) * d2.mean_s
            lp_std = pre.std_s + (k - 1) * d2.std_s
            name = type_name(cls, length)
            profiles[name] = TaskProfile(
                name=name, hp_exec=pre.mean_s, hp_pad=pre.std_s,
                lp_exec={d: lp_mean * s for d, s in scale.items()},
                lp_pad={d: lp_std * s for d, s in scale.items()})
    first = type_name(traffic["classes"][0],
                      traffic["classes"][0]["prompt_lens"][0])
    return WorkloadSpec(name="portbench", profiles=profiles,
                        default_type=first)


def type_name(cls: dict, length: int) -> str:
    return f"{cls['name']}.{length}"


def claimed_slots(spec) -> dict:
    """type -> {units: slot seconds} as the scheduler reserves them."""
    out = {}
    for name, p in spec.profiles.items():
        out[name] = {1: p.hp_slot_time,
                     **{u: p.lp_slot_time(u) for u in p.core_options}}
    return out


def cache_len_of(traffic: dict) -> int:
    return max(length + c["new_tokens"] for c in traffic["classes"]
               for length in c["prompt_lens"])


class ServeRun:
    """One run of a serving cell (or of the sweep, with ``stub`` compute)."""

    def __init__(self, cell: bench.Cell, seed: int, device,
                 traced_run: bool = False, stub: bool = False,
                 fault: str | None = None):
        self.seed = seed
        self.dev = torch.device(device)
        self.traffic = cell.traffic
        self.eng_cfg = self.traffic["engine"]
        self.cfg = bench.port_config(cell.config)
        self.ref = bench.reference_model(cell.config)
        self.dims = self.ref.Dims.from_published(bench.values(cell.config))
        self.trace_on, self.stub, self.fault = traced_run, stub, fault
        self.cache_len = cache_len_of(self.traffic)
        self.counters = {"prefills": 0, "decodes": 0}
        self.requests: list = []      # (episode, plan, ServeRequest)
        self.judged = sample_plan(self.traffic, seed,
                                  self.eng_cfg["n_slices"])
        self.watch: dict = {}         # rid -> ServeRequest, of the judged
        self.kv: dict = {}            # rid -> the last layer's (K, V) rows
        self.metrics: list = []

    # ------------------------------------------------------------------ #
    def setup(self, costs: dict | None = None) -> None:
        """Weights, the measured slot table (unless given), the task types."""
        from repro_torch.serving.cost_model import measure_cost_model
        from repro_torch.serving.engine import engine_network_config
        self.weights = ({"embed": torch.empty(0, device=self.dev)}
                        if self.stub else
                        make_weights(self.cfg, self.seed, self.dev))
        lengths = sorted({n for c in self.traffic["classes"]
                          for n in c["prompt_lens"]})
        if costs is None:
            # The slots at the host-paced lengths come from a few
            # host-fenced reps: one stall of the host inflates a mean and
            # its std together, and a slot past its frozen deadline fails
            # every request of its length.  So each length is measured
            # COST_TRIALS times (garbage collection off) and the trial
            # with the shorter padded prefill and decode step is kept.
            gc.disable()
            try:
                costs = {n: min(
                    (measure_cost_model(
                        self.cfg, prompt_len=n, cache_len=self.cache_len,
                        degrees=(2, 4), reps=COST_REPS,
                        seed=gen.seed_mix(self.seed, 3, n, t),
                        device=self.dev)
                     for t in range(COST_TRIALS)),
                    key=lambda c: c.prefill[1].padded + c.decode[2].padded)
                    for n in lengths}
            finally:
                gc.enable()
            gc.collect()                 # the cost model's own weights
        self.costs = costs
        self.spec = build_spec(self.traffic, costs)
        main = self.traffic["classes"][0]
        self.net = engine_network_config(
            costs[main["prompt_lens"][0]], main["new_tokens"],
            workload=self.spec)
        self.deadlines = {type_name(c, n): c["deadline_s"][str(n)]
                          for c in self.traffic["classes"]
                          for n in c["prompt_lens"]}

    # ------------------------------------------------------------------ #
    def _engine(self):
        from repro_torch.serving.engine import PreemptiveServingEngine
        e = self.eng_cfg
        eng = PreemptiveServingEngine(
            self.cfg, self.weights, None, device=self.dev,
            n_slices=e["n_slices"], units_per_slice=e["units_per_slice"],
            preemption=e["preemption"], lose_work=e["lose_work"],
            cache_len=self.cache_len, net=self.net,
            victim_policy=e["victim_policy"], policy=e["policy"])
        pre, srv, compute = eng._prefill, eng._serve, eng._run_compute
        cnt, on = self.counters, self.trace_on
        now = {"rid": None, "caches": None}   # the slot computing

        if self.stub:                     # the schedule alone: no compute
            zero = torch.zeros(1, dtype=torch.int32)

            def prefill(params, batch, caches=None):
                return zero, None

            def serve(params, caches, token, pos):
                return zero[:, None], None
        else:
            def prefill(params, batch, caches=None):
                cnt["prefills"] += 1
                with span(on, f"serve.prefill:T={batch['tokens'].shape[1]}"):
                    nxt, caches = pre(params, batch)
                if self.fault == "token":    # altered where produced
                    nxt = (nxt + 1) % self.dims.vocab_size
                if now["rid"] in self.watch:
                    now["caches"] = caches
                return nxt, caches

            def serve(params, caches, token, pos):
                cnt["decodes"] += 1
                with span(on, f"serve.decode:pos={pos}"):
                    nxt, caches = srv(params, caches, token, pos)
                if now["rid"] in self.watch:
                    now["caches"] = caches
                return nxt, caches

            def run_compute(task):
                """The slot's compute; for a judged request, then a copy
                of the rows of its KV cache that the last layer holds."""
                now["rid"] = task.frame_id
                compute(task)
                req = self.watch.get(task.frame_id)
                if req is not None:
                    n = req.prompt.shape[1] + len(req.tokens_out) - 1
                    self.kv[req.rid] = last_layer_kv(now["caches"], n)
                now["rid"] = now["caches"] = None
            eng._run_compute = run_compute
        eng._prefill, eng._serve = prefill, serve
        return eng

    def episode(self, index: int) -> None:
        from repro_torch.core.task import Priority
        from repro_torch.serving.engine import ServeRequest
        e = self.eng_cfg
        plans = gen.episode(self.traffic, self.seed, index, e["n_slices"])
        g = None
        if not self.stub:
            g = torch.Generator(device=self.dev)
            g.manual_seed(gen.seed_mix(self.seed, 5, index))
        with span(self.trace_on, "episode.setup"):
            eng = self._engine()
            for i, plan in enumerate(plans):
                ttype = f"{plan['cls']}.{plan['prompt_len']}"
                # prompt tokens uniform over the vocabulary
                prompt = (torch.empty((1, plan["prompt_len"]),
                                      dtype=torch.long) if self.stub else
                          torch.randint(0, self.dims.vocab_size,
                                        (1, plan["prompt_len"]), generator=g,
                                        device=self.dev))
                req = ServeRequest(
                    prompt=prompt, max_new_tokens=plan["new_tokens"],
                    priority=Priority.HIGH if plan["hp"] else Priority.LOW,
                    deadline=plan["t"] + self.deadlines[ttype],
                    home_slice=plan["home"], task_type=ttype)
                eng.q.push(plan["t"], lambda r=req: eng.submit(r))
                self.requests.append((index, plan, req))
                if (index, i) in self.judged:
                    self.watch[req.rid] = req
        with span(self.trace_on, "engine.run"):
            self.metrics.append(eng.run())
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> float:
        """Whole episodes until ``seconds`` of wall time have passed and
        the judged sample's episodes have run; -> the window's wall
        seconds (to the end of its last episode)."""
        gc.collect()                      # the set-up's garbage, not the
        gc.freeze()                       # window's, and not traversed in it
        t0 = time.perf_counter()
        index = 0
        while True:
            self.episode(index)
            index += 1
            if (time.perf_counter() - t0 >= seconds
                    and index >= self.traffic["check"]["episodes"]):
                break
        self.episodes = index
        return time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    def outcomes(self) -> dict:
        """Requests sent and done by class, and the prompt and generated
        tokens of the requests done."""
        hp = [r for _, p, r in self.requests if p["hp"]]
        lp = [r for _, p, r in self.requests if not p["hp"]]
        return {"hp_sent": len(hp), "lp_sent": len(lp),
                "hp_done": sum(r.state == "done" for r in hp),
                "lp_done": sum(r.state == "done" for r in lp),
                "done_tokens": sum(r.prompt.shape[1] + len(r.tokens_out)
                                   for _, _, r in self.requests
                                   if r.state == "done")}

    def records(self) -> list:
        out = []
        for ep, plan, r in self.requests:
            t = r.task
            out.append({
                "episode": ep, "rid": r.rid, "hp": plan["hp"],
                "home": plan["home"],
                "arrival": r.arrival, "deadline": r.deadline,
                "state": r.state, "completed_at": r.completed_at,
                "tokens": list(r.tokens_out),
                "max_new_tokens": r.max_new_tokens,
                "task_type": r.task_type,
                "slice": -1 if t is None or t.device is None else t.device,
                "units": 0 if t is None else t.cores,
                "t_start": 0.0 if t is None else t.t_start,
                "t_end": 0.0 if t is None else t.t_end,
                "prompt_len": plan["prompt_len"]})
        return out

    def sample(self) -> list:
        """The judged requests (``sample_plan``) that were done."""
        return [r for r in self.watch.values() if r.state == "done"]

    def free_program(self, keep: list = ()) -> None:
        """Drop the program's state but the K/V copies of ``keep``."""
        self.kv = {r.rid: self.kv[r.rid] for r in keep}
        for _, _, r in self.requests:
            r.task = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def sample_plan(traffic: dict, seed: int, n_slices: int) -> set:
    """(episode, index in its plan) of the requests the reference judges,
    fixed before the window from the seeded plans of the first
    ``check.episodes`` episodes: every LP request (a served token each
    decode step), and ``check.hp_requests`` HP requests drawn from the seed
    with the longest prompt among them."""
    chk = traffic["check"]
    keep, hp = set(), []
    for e in range(chk["episodes"]):
        for i, p in enumerate(gen.episode(traffic, seed, e, n_slices)):
            if p["hp"]:
                hp.append((p["prompt_len"], e, i))
            else:
                keep.add((e, i))
    if hp:
        longest = max(range(len(hp)), key=lambda j: hp[j][0])
        rest = [j for j in gen.rng_for(seed, 7).permutation(len(hp))
                if j != longest]
        keep |= {hp[j][1:] for j in [longest] + rest[: chk["hp_requests"] - 1]}
    return keep


def last_layer_kv(caches: dict, n: int) -> tuple:
    """Copies of the first ``n`` rows of K and V [n, KV, D] that the last
    layer's cache holds (the port's tree: stages ``dec*`` of pattern slots
    ``p*``, each leaf [layers, batch, slots, KV, D])."""
    stage = caches[max(caches)]
    slot = stage[max(stage)]["self"]
    return slot["k"][-1, 0, :n].clone(), slot["v"][-1, 0, :n].clone()


def judge(ref, weights: dict, dims, reqs: list, kv: dict,
          precision: str = "f32", control: bool = False) -> tuple:
    """The reference (module ``ref``, in f32) over each request's prompt
    and served tokens -> (the gaps by which the served tokens' logits lie
    below the reference's best, one a served token; each request's largest
    difference of the last layer's K or V rows from the reference's, over
    the reference's largest magnitude).  With ``control`` the reference in
    ``precision`` takes the program's place: its first tokens and its K/V
    are judged."""
    gaps, kv_err = [], []
    for r in reqs:
        toks = list(r.tokens_out)
        prompt = r.prompt[0].to(weights["embed"].device)
        seq = torch.cat([prompt, torch.tensor(toks[:-1], dtype=prompt.dtype,
                                              device=prompt.device)])
        at = list(range(prompt.shape[0] - 1, seq.shape[0]))
        want, k, v = ref.serve_outputs(weights, dims, seq, at, "f32")
        if control:
            low, gk, gv = ref.serve_outputs(weights, dims, seq, at, precision)
            toks = low.argmax(dim=-1).tolist()
        else:
            gk, gv = kv[r.rid]
        best = want.max(dim=-1).values
        got = want[torch.arange(len(at)), torch.tensor(toks)]
        gaps.extend((best - got).tolist())
        kv_err.append(max(float((gk - k).abs().max() / k.abs().max()),
                          float((gv - v).abs().max() / v.abs().max())))
    return gaps, kv_err


def run(cell: bench.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", fault: str | None = None) -> dict:
    """One run of a serving cell -> {"result", "checks"}."""
    sr = ServeRun(cell, seed, device, traced_run=trace, fault=fault)
    sr.setup()
    setup_s = time.perf_counter() - t_start
    with traced(trace, torch) as holder:
        window_s = sr.window(seconds)
    peak = torch.cuda.max_memory_allocated() if sr.dev.type == "cuda" else 0
    out = sr.outcomes()
    recs = sr.records()
    sample = sr.sample()
    sr.free_program(keep=sample)

    # correct: the schedule, then the served tokens against the reference
    faults = []
    for ep in range(sr.episodes):          # each episode its own engine
        faults += ref_schedule.check(
            [r for r in recs if r["episode"] == ep], claimed_slots(sr.spec),
            sr.eng_cfg["n_slices"], sr.eng_cfg["units_per_slice"],
            sr.dims.vocab_size)
    for f in faults[:5]:
        print(f"schedule fault: {f}", file=sys.stderr)
    gaps, kv_err = judge(sr.ref, sr.weights, sr.dims, sample, sr.kv)
    lim = cell.traffic["check"]
    checks = {
        "judged_tokens": {"value": len(gaps),
                          "limit": sum(r.max_new_tokens
                                       for r in sr.watch.values())},
        "schedule_faults": {"value": len(faults), "limit": 0},
        "logit_gap": {"value": max(gaps, default=float("inf")),
                      "limit": lim["logit_gap"]},
        "kv_rel_err": {"value": max(kv_err, default=float("inf")),
                       "limit": lim["kv_rel_err"]},
    }
    # every judged request done and judged (a lower limit), every other
    # number within its upper limit
    correct = (len(gaps) >= checks["judged_tokens"]["limit"]
               and all(c["value"] <= c["limit"] for name, c in checks.items()
                       if name != "judged_tokens"))
    sent = out["hp_sent"] + out["lp_sent"]
    result = {"correct": bool(correct), "attempted": sent,
              "failed": sent - out["hp_done"] - out["lp_done"]}
    if trace:
        ctx = {"run": sr, "outcomes": out, "trace": holder.trace,
               "window_s": window_s, "tf32": False,
               "dtype": sr.cfg.param_dtype}
        result["metrics"] = bench.read_per_layer(cell, ctx)
        result["breakdown"] = {"device_ops": holder.trace.device_ops,
                               "idle_gaps": holder.trace.idle_gaps}
    else:
        result["metrics"] = {
            "served_tok_s": out["done_tokens"] / window_s,
            "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in result["metrics"].items()
                             if k in units}
    result["peak"] = peak
    result["trace"] = holder.trace
    result["info"] = {"episodes": sr.episodes, "window_s": window_s,
                      **out, "decodes": sr.counters["decodes"],
                      "prefills": sr.counters["prefills"],
                      "served_tok_s": out["done_tokens"] / window_s}
    return {"result": result, "checks": checks}
