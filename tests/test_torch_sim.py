"""The port's runtime planes (``repro_torch.sim``, ``serving/stream.py``,
``core/telemetry.py``, ``core/calendar_reference.py``) against the JAX
package's: the paper's testbed replays its committed goldens, and the
large-N, streaming, chaos and degrade-storm runs give the same reports in
both packages (host wall-clock fields dropped)."""
import json
import random
from dataclasses import astuple, replace
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import repro.core.task as jax_task
import repro.sim as jax_sim
from repro.core.telemetry import LogHistogram as JLogHistogram
from repro.serving.stream import StreamingEngine as JStreamingEngine
from repro.sim import chaos as jax_chaos
from repro.sim import degrade_storm as jax_storm
from repro.sim.churn import ChurnConfig as JChurnConfig, \
    ChurnInjector as JChurnInjector
from repro.sim.openended import FirehoseConfig as JFirehoseConfig, \
    firehose as jfirehose
from repro.sim.scenarios import LargeNConfig as JLargeNConfig, \
    run_large_n as jrun_large_n
import repro_torch.core.task as torch_task
from repro_torch.core.calendar import DeviceCalendar, LinkCalendar
from repro_torch.core.calendar_reference import ReferenceDeviceCalendar, \
    ReferenceLinkCalendar
from repro_torch.core.telemetry import LogHistogram
from repro_torch.serving.stream import StreamingEngine
from repro_torch.sim import (CHAOS_SCENARIOS, MIXED_SCENARIOS, SCENARIOS,
                             ChurnConfig, ChurnInjector, FirehoseConfig,
                             LargeNConfig, chaos_gate, firehose, run_chaos,
                             run_large_n, run_scenario)
from repro_torch.sim import degrade_storm as storm

GOLDEN = Path(__file__).parent / "data" / "golden_scenarios.json"
ALL_GOLDEN = {**SCENARIOS, **MIXED_SCENARIOS}


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN.read_text())


def _virtual(summary: dict) -> dict:
    """``Metrics.summary()`` without its host wall-clock timings."""
    return {k: v for k, v in summary.items() if not k.startswith("t_")}


@pytest.mark.parametrize("name", sorted(ALL_GOLDEN))
def test_run_scenario_reproduces_the_golden(name, golden):
    cfg = replace(ALL_GOLDEN[name], n_frames=golden["n_frames"])
    assert _virtual(run_scenario(cfg).summary()) == \
        golden["summaries"][name]


@pytest.mark.parametrize("name", chip_smoke.SIM_SCENARIOS)
def test_the_card_phase_table_is_the_jax_package_at_1296_frames(name):
    """The ``[sim]`` phase holds the port's paper scenarios on the card
    machine against ``chip_smoke.PAPER_1296``: that table is what the JAX
    package gives at the scenarios' full 1296 frames."""
    cfg = jax_sim.SCENARIOS[name]
    assert cfg.n_frames == 1296
    s = jax_sim.run_scenario(cfg).summary()
    assert (s["hp_completion_pct"], s["frame_completion_pct"],
            s["preemptions"], s["realloc_success"]) == \
        chip_smoke.PAPER_1296[name]


# host wall-clock fields of run_large_n's summary
LARGE_N_WALL = {"hp_alloc_us_mean", "hp_alloc_us_p99", "hp_preempt_us_mean",
                "lp_alloc_us_mean", "lp_alloc_us_p99", "wall_s"}


def _large_n_churn(pkg_config, pkg_injector):
    return pkg_injector(pkg_config(
        name="large_churn", n_devices=64, fail_rate=0.5, drain_rate=0.25,
        duration=10.0, start=2.0, rejoin_delay=2.0, seed=3))


@pytest.mark.parametrize("churn", [False, True], ids=["no-churn", "churn"])
@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_run_large_n_matches_jax(arrival, churn):
    kw = dict(name="large", n_devices=64, duration=16.0, arrival=arrival,
              hp_rate=0.1, seed=5)
    j_churn = _large_n_churn(JChurnConfig, JChurnInjector) if churn else None
    t_churn = _large_n_churn(ChurnConfig, ChurnInjector) if churn else None
    jax_task.reset_id_counters()
    want = jrun_large_n(JLargeNConfig(**kw), churn=j_churn)
    torch_task.reset_id_counters()
    got = run_large_n(LargeNConfig(**kw), churn=t_churn)
    assert got.keys() == want.keys()
    drop = lambda d: {k: v for k, v in d.items()  # noqa: E731
                      if k not in LARGE_N_WALL}
    assert drop(got) == drop(want)
    assert want["hp_admitted"] > 0 and want["lp_allocated"] > 0
    if churn:
        assert want["device_failures"] >= 1


def _stream_report(engine_cls, fire_cls, fire, churn, reset, **kw):
    """A firehose through a streaming engine, wall-clock fields dropped
    (the latency sketches of the scheduler's own decisions)."""
    reset()
    eng = engine_cls(16, queue_capacity=256, window=0.25, **kw)
    cfg = fire_cls(n_devices=16, rate=40.0, lp_fraction=0.4, seed=9)
    report = eng.run(fire(cfg, limit=1500), churn=churn)
    report["metrics"] = _virtual(report["metrics"])
    report["telemetry"].pop("admission_latency_s", None)
    return report


def _stream_churn(pkg_config, pkg_injector):
    return pkg_injector(pkg_config(
        name="stream_churn", n_devices=16, fail_rate=0.3, drain_rate=0.2,
        duration=25.0, start=2.0, rejoin_delay=3.0, seed=4))


@pytest.mark.parametrize("shed", ["reject_newest", "reject_cheapest"])
@pytest.mark.parametrize("churn", [False, True], ids=["no-churn", "churn"])
def test_streaming_engine_matches_jax(churn, shed):
    j_inj = _stream_churn(JChurnConfig, JChurnInjector) if churn else None
    t_inj = _stream_churn(ChurnConfig, ChurnInjector) if churn else None
    if churn:
        assert [astuple(e) for e in t_inj] == [astuple(e) for e in j_inj]
    want = _stream_report(JStreamingEngine, JFirehoseConfig, jfirehose,
                          iter(j_inj) if churn else None,
                          jax_task.reset_id_counters, shed=shed)
    got = _stream_report(StreamingEngine, FirehoseConfig, firehose,
                         iter(t_inj) if churn else None,
                         torch_task.reset_id_counters, shed=shed)
    assert got == want
    assert want["unresolved"] == 0
    assert want["metrics"]["hp_generated"] > 0
    if churn:
        assert want["metrics"]["orphans_created"] >= 1


@pytest.mark.parametrize("name", ["smoke", "churn_mixed"])
def test_run_chaos_matches_jax_and_passes_its_gate(name):
    jax_task.reset_id_counters()
    want = jax_chaos.run_chaos(jax_chaos.CHAOS_SCENARIOS[name])
    torch_task.reset_id_counters()
    got = run_chaos(CHAOS_SCENARIOS[name])
    for res in (want, got):
        res["report"]["metrics"] = _virtual(res["report"]["metrics"])
        res["report"]["telemetry"].pop("admission_latency_s", None)
    assert got == want
    assert chaos_gate(got, CHAOS_SCENARIOS[name]) == []
    assert got["orphans_created"] >= 1


def test_degrade_storm_smoke_matches_jax_and_passes_its_gate():
    jax_task.reset_id_counters()
    want = jax_storm.run_storm(jax_storm.STORM_SCENARIOS["smoke"])
    torch_task.reset_id_counters()
    got = storm.run_storm(storm.STORM_SCENARIOS["smoke"])
    assert got == want
    assert storm.storm_gate(got, storm.STORM_SCENARIOS["smoke"]) == []
    assert got["degrade"]["lp_degraded"] > 0


@pytest.mark.parametrize("dist", ["lognormal", "bimodal"])
def test_log_histogram_quantiles_match_jax(dist):
    rng = np.random.default_rng(7)
    if dist == "lognormal":
        xs = np.exp(rng.normal(-4.0, 1.5, 20_000))
    else:
        xs = np.where(rng.random(20_000) < 0.7,
                      rng.uniform(1e-4, 1e-3, 20_000),
                      rng.uniform(1.0, 2.0, 20_000))
    got, want = LogHistogram(), JLogHistogram()
    got.record_many(xs.tolist())
    want.record_many(xs.tolist())
    qs = (0.0, 0.5, 0.9, 0.99, 0.999, 1.0)
    assert got.quantiles(qs) == want.quantiles(qs)
    assert got.snapshot() == want.snapshot()


@pytest.mark.parametrize("seed", range(12))
def test_calendar_reference_matches_the_port_calendar(seed):
    """A short fuzz of the port's skyline calendar against its list-based
    reference (queries at or after the gc horizon, as the scheduler
    makes them)."""
    rng = random.Random(seed)
    new, ref = DeviceCalendar(0, 4), ReferenceDeviceCalendar(0, 4)
    link, link_ref = LinkCalendar(), ReferenceLinkCalendar()
    live, now = [], 0.0
    for op in range(60):
        c = rng.random()
        if c < 0.45 or not live:
            t1 = now + rng.uniform(0, 30)
            t2 = t1 + rng.uniform(0.05, 10)
            cores = rng.choice([1, 2, 4])
            new.reserve(t1, t2, cores, (seed, op))
            ref.reserve(t1, t2, cores, (seed, op))
            live.append((seed, op))
        elif c < 0.60:
            tag = live.pop(rng.randrange(len(live)))
            assert (new.release(tag) is None) == (ref.release(tag) is None)
        elif c < 0.70:
            tag = rng.choice(live)
            r = ref.get(tag)
            t_end = rng.uniform(r.t1 - 1.0, r.t2 + 1.0)
            new.truncate(tag, t_end)
            ref.truncate(tag, t_end)
            if ref.get(tag) is None:
                live.remove(tag)
        else:
            now += rng.uniform(0, 10)
            for cal in (new, ref, link, link_ref):
                cal.gc(now)
            live = [t for t in live if ref.get(t) is not None]
        dur = rng.uniform(0.01, 3.0)
        nb = now + rng.uniform(0, 20)
        assert link.reserve_earliest(dur, nb, op).t1 == pytest.approx(
            link_ref.reserve_earliest(dur, nb, op).t1, abs=1e-12)
        q1 = now + rng.uniform(0, 40)
        q2 = q1 + rng.uniform(0.01, 20)
        assert new.max_usage(q1, q2) == ref.max_usage(q1, q2)
        assert new.free_cores(q1, q2) == ref.free_cores(q1, q2)
        for cores in (1, 2, 4):
            assert new.fits(q1, q2, cores) == ref.fits(q1, q2, cores)
        assert new.completion_times(q1, q2) == ref.completion_times(q1, q2)
        assert len(new) == len(ref) and len(link) == len(link_ref)
