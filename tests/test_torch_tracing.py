"""The port's spans (``repro_torch/tracing.py``) on the CPU: nothing is built
or recorded without a profiler; under one, the serving engine's and the
train step's ranges nest and carry what the benchmark's readers parse; and
the engine's compute counters (``compute_s``, ``wasted_s``)."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core.task import Priority
from repro_torch.models import model as M
from repro_torch.serving.cost_model import CostModel, PhaseCost
from repro_torch.serving.engine import (
    PreemptiveServingEngine,
    ServeRequest,
    engine_network_config,
)
from repro_torch.training.steps import init_train_state, make_train_step

STEP_PREFIXES = ("engine.prefill:T=", "engine.decode:pos=")


@pytest.fixture(scope="module")
def tiny():
    cfg = get_smoke_config("qwen2-0.5b")
    cost = CostModel()
    cost.prefill[1] = PhaseCost(0.05, 0.005)
    cost.decode[2] = PhaseCost(0.02, 0.002)
    cost.decode[4] = PhaseCost(0.014, 0.0014)
    return cfg, M.init_params(cfg, 0, device="cpu"), cost


def _prompt(cfg, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32))


def _engine(tiny, lose_work=True):
    """LP work that fills slice 0 at t=0 and HP requests at 0.01 and 0.03
    that preempt it, with LP work offloadable from slice 1: the slots,
    reads and preemptions of a real run, small enough for the CPU."""
    cfg, params, cost = tiny
    net = engine_network_config(cost, 4)
    eng = PreemptiveServingEngine(cfg, params, cost, device="cpu",
                                  n_slices=2, units_per_slice=4, net=net,
                                  lose_work=lose_work)
    reqs = []
    for i in range(4):
        reqs.append((0.0, ServeRequest(
            prompt=_prompt(cfg, i + 2), max_new_tokens=4,
            priority=Priority.LOW, deadline=120.0, home_slice=0)))
    for i, at in enumerate((0.01, 0.03)):
        reqs.append((at, ServeRequest(
            prompt=_prompt(cfg, 40 + i), max_new_tokens=1,
            priority=Priority.HIGH, deadline=at + net.t_hp * 2 + 0.2,
            home_slice=0)))
    reqs.append((0.0, ServeRequest(
        prompt=_prompt(cfg, 60), max_new_tokens=3, priority=Priority.LOW,
        deadline=60.0, home_slice=1)))
    for at, r in reqs:
        eng.q.push(at, lambda r=r: eng.submit(r))
    return eng, [r for _, r in reqs]


def _fields(name):
    return dict(f.split("=") for f in name.split(":")[1:])


def _events(fn):
    """(name, start us, end us) of every event while ``fn`` runs under a CPU
    profiler: the ranges the port opened and the operators it ran."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def _ranges(events):
    """The port's ranges among ``events``."""
    return [e for e in events if e[0].startswith(("engine.", "train."))]


def test_on_follows_the_profiler():
    assert not tracing.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
    assert not tracing.on()


def test_without_a_profiler_nothing_is_built_or_recorded(tiny, monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        raise AssertionError("a range opened with no profiler")

    def event(*a, **k):
        raise AssertionError("a CUDA event made with no profiler")

    def name():
        raise AssertionError("a span name built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "Event", event)
    tracing.clear()
    assert tracing.span(name) is tracing.span(name, device=True)
    with tracing.span(name, device=True):
        pass
    eng, reqs = _engine(tiny)
    eng.run()
    assert any(r.state == "done" for r in reqs)
    cfg, _, _ = tiny
    params, state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    step(params, state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert opened == []
    assert tracing.device_spans() == []


@pytest.fixture(scope="module")
def traced_engine(tiny):
    eng, reqs = _engine(tiny)
    return eng, reqs, _events(eng.run)


def _outcomes(reqs):
    return [(r.state, r.completed_at, r.n_preemptions, list(r.tokens_out),
             r.task.device, r.task.cores, r.task.t_start, r.task.t_end)
            for r in reqs]


def test_engine_spans_nest_and_carry_their_requests(tiny, traced_engine):
    eng, reqs, spans = traced_engine
    plain, plain_reqs = _engine(tiny)
    plain.run()
    assert _outcomes(reqs) == _outcomes(plain_reqs)
    assert plain.metrics.summary()["preemptions"] == \
        eng.metrics.summary()["preemptions"]
    program = _ranges(spans)
    names = [n for n, _, _ in program]
    kinds = {n.split(":")[0] for n in names}
    assert kinds == {"engine.admit", "engine.slot", "engine.prefill",
                     "engine.decode", "engine.read"}
    rids = {r.rid for r in reqs}
    admitted = {int(_fields(n)["rid"]) for n in names
                if n.startswith("engine.admit:rid=")}
    assert admitted == rids
    slots = [s for s in program if s[0].startswith("engine.slot:")]
    assert {int(_fields(n)["rid"]) for n, _, _ in slots} == {
        r.rid for r in reqs if r.state == "done"}
    steps = [s for s in program if s[0].startswith(STEP_PREFIXES)]
    reads = [s for s in program if s[0] == "engine.read"]
    assert len(reads) == len(steps) > len(slots)
    within = lambda inner, outer: outer[1] <= inner[1] and \
        inner[2] <= outer[2]                                # noqa: E731
    for r in reads:
        assert sum(within(r, s) for s in steps) == 1
    for s in steps:
        assert sum(within(s, o) for o in slots) == 1
    by_rid = {}
    for n, _, _ in slots:
        by_rid.setdefault(int(_fields(n)["rid"]), []).append(n)
    for r in reqs:
        if r.n_preemptions or r.state != "done":
            continue
        (n,) = by_rid[r.rid]
        f = _fields(n)
        assert int(f["units"]) == r.task.cores
        assert int(f["reserved_us"]) == round(
            (r.task.t_end - r.task.t_start) * 1e6)
    assert any(r.n_preemptions for r in reqs)


def test_program_span_names_are_spans_and_never_device_work(tiny,
                                                            monkeypatch):
    """The port's naming rule for every range it opens, in the engine and
    the train step: ``engine.`` or ``train.``, never ``serve.`` (the
    benchmark's own prefix).  That the benchmark's trace reduction counts
    none of these as device work is the benchmark's own test."""
    opened = []
    record_function = torch.profiler.record_function

    def recording(name):
        opened.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    cfg, _, _ = tiny
    params, state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 17))
    eng, _ = _engine(tiny)

    def both():
        eng.run()
        step(params, state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})

    names = {n for n, _, _ in _events(both)}
    assert {n.split(":")[0] for n in opened} == {
        "engine.admit", "engine.slot", "engine.prefill", "engine.decode",
        "engine.read", "train.grads", "train.optimizer"}
    assert set(opened) <= names
    for name in opened:
        assert name.startswith(("engine.", "train."))
        assert not name.startswith("serve.")


def _replay(eng, reqs):
    """Run the engine recording each request's slots' compute seconds and
    its preemptions and lost slices, in order."""
    log = {r.rid: [] for r in reqs}
    by_task = eng._by_task
    run_compute, client = eng._run_compute, eng.dispatcher.client
    on_preempt, on_lost = client.on_preempt, client.on_device_lost

    def slot(task):
        req = by_task[task]
        before = req.compute_s
        run_compute(task)
        log[req.rid].append(("slot", req.compute_s - before))

    def preempt(task):
        log[by_task[task].rid].append(("preempt", 0.0))
        on_preempt(task)

    def lost(task):
        log[by_task[task].rid].append(("lost", 0.0))
        on_lost(task)

    eng._run_compute = slot
    client.on_preempt, client.on_device_lost = preempt, lost
    eng.run()
    return log


@pytest.mark.parametrize("lose_work", [True, False])
def test_wasted_compute_is_the_attempts_thrown_away(tiny, lose_work):
    eng, reqs = _engine(tiny, lose_work=lose_work)
    log = _replay(eng, reqs)
    # an LP slot began (its compute ran) before an HP request took its units
    started = [r for r in reqs if ("preempt", 0.0) in log[r.rid][1:]
               and log[r.rid][0][0] == "slot"]
    assert started
    for r in reqs:
        assert r.state in ("done", "failed")
        assert r.compute_s == pytest.approx(sum(d for _, d in log[r.rid]))
        if not lose_work:
            assert r.wasted_s == 0.0
    if lose_work:
        for r in started:
            first = log[r.rid][0][1]
            assert first > 0 and r.wasted_s == pytest.approx(first)
            # the done request's last attempt is not counted
            assert r.compute_s - r.wasted_s == pytest.approx(
                log[r.rid][-1][1])
        for r in set(reqs) - set(started):
            assert r.wasted_s == 0.0


def test_each_slot_keeps_its_units_reservation_and_compute(tiny):
    """``slots`` is kept with no profiler: one entry a ``_run_compute``, the
    task's units and reservation at that slot, its compute seconds summing
    to ``compute_s``."""
    eng, reqs = _engine(tiny)
    at_slot = {r.rid: [] for r in reqs}
    run_compute = eng._run_compute

    def slot(task):
        at_slot[eng._by_task[task].rid].append(
            (task.cores, task.t_end - task.t_start))
        run_compute(task)

    eng._run_compute = slot
    eng.run()
    assert any(len(r.slots) > 1 for r in reqs)
    for r in reqs:
        assert [s[:2] for s in r.slots] == at_slot[r.rid]
        assert all(s[2] > 0 for s in r.slots)
        assert sum(s[2] for s in r.slots) == pytest.approx(r.compute_s)


def test_a_lost_slice_and_an_unfinished_request_waste_their_attempts(tiny):
    eng, reqs = _engine(tiny, lose_work=False)
    eng.q.push(0.005, lambda: eng.fail_slice(0))
    log = _replay(eng, reqs)
    lost = [r for r in reqs if ("lost", 0.0) in log[r.rid]]
    assert lost
    for r in lost:
        i = log[r.rid].index(("lost", 0.0))
        thrown = sum(d for _, d in log[r.rid][:i])
        if r.state == "done":
            assert r.wasted_s == pytest.approx(thrown)
        else:
            assert r.wasted_s == pytest.approx(r.compute_s)
    for r in reqs:
        if r.state != "done":
            assert r.wasted_s == pytest.approx(r.compute_s)
        assert r.attempt_s == 0.0 or r.state == "done"


def test_train_step_spans_once_a_step(tiny):
    cfg, _, _ = tiny
    params, state = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tracing.clear()

    def two_steps():
        nonlocal params, state
        for _ in range(2):
            params, state, _ = step(params, state, batch)

    spans = sorted(_ranges(_events(two_steps)), key=lambda s: s[1])
    names = [n for n, _, _ in spans]
    assert names.count("train.grads") == 2
    assert names.count("train.optimizer") == 2
    assert names == ["train.grads", "train.optimizer"] * 2
    assert tracing.device_spans() == []        # no card: no events


def test_device_spans_filter_by_prefix_after_one_synchronize(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: synced.append(1))

    class Ev:
        def __init__(self, t): self.t = t
        def elapsed_time(self, end): return end.t - self.t

    tracing.clear()
    tracing._pairs.extend([("train.grads", Ev(0.0), Ev(5.0)),
                           ("train.optimizer", Ev(5.0), Ev(7.5)),
                           ("train.optimizer", Ev(9.0), Ev(10.0))])
    try:
        assert tracing.device_spans("train.optimizer") == [
            ("train.optimizer", 2.5), ("train.optimizer", 1.0)]
        assert synced == [1]
        assert tracing.device_spans("engine.") == []
        assert synced == [1]
    finally:
        tracing.clear()
    assert tracing.device_spans() == []
