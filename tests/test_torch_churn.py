"""Slice churn through the port's PreemptiveServingEngine on
``device="cpu"``: the scripted cross-engine run of
tests/test_torch_serving.py with slices failing, draining and rejoining
mid-run.  Both packages' engines must agree on every per-request outcome
and on the virtual-time metrics summary, and a request that lost its slice
and was re-placed restarts from its prompt and decodes the tokens it
decodes without churn.

The placed schedule is ``chip_smoke.placed_churn``'s (the card's
``[churn]`` phase) on the script's own timelines.  The script runs on 3 slices: on 2,
both are full whenever slice 0 holds LP and HP work, so no orphan could
be re-placed."""
import dataclasses

import pytest

from chip_smoke import churn_events, placed_churn
from repro.sim.churn import ChurnConfig as JChurnConfig, \
    ChurnInjector as JChurnInjector
from repro_torch.sim.churn import ChurnConfig, ChurnInjector
from test_torch_serving import _run_script, _setup, _virtual

ARCHS = ["qwen2-0.5b", "xlstm-1.3b"]
N_SLICES = 3
# a schedule of the injector that fails both slices of the 2-slice script,
# drains one and rejoins them while its work is in flight
SCHEDULE_SEED = 5


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _failures(lost):
    """What each failure met: time, slice, its orphans' (rid, priority,
    state before) and the rids re-placed at once."""
    return [(f["t"], f["slice"],
             [(r.rid, r.priority.name, was) for r, was in f["orphans"]],
             [r.rid for r in f["replaced"]]) for f in lost]


def _check_runs(setup, lose_work, base, events, n_slices):
    """The script with ``events`` through both engines -> (the port's
    summary, the failures it met, ids of requests done after a restart).
    The engines must agree on outcomes, summary and failures."""
    lost = {"jax": [], "torch": []}
    runs = {kind: _run_script(kind, setup, lose_work, n_slices=n_slices,
                              probe=churn_events(events, lost[kind]))
            for kind in lost}
    (j_out, j_sum), (t_out, t_sum) = runs["jax"], runs["torch"]
    assert t_out == j_out
    assert t_sum.keys() == j_sum.keys()
    assert _virtual(t_sum) == _virtual(j_sum)
    failures = _failures(lost["torch"])
    assert failures == _failures(lost["jax"])
    assert [f[1] for f in failures] == \
        [idx for _, kind, idx in events if kind == "fail"]
    assert t_sum["orphans_created"] >= 1 and t_sum["orphans_recovered"] >= 1
    # every request settles; an HP request lost with its slice is counted
    assert all(o[1] in ("done", "failed") for o in t_out)
    assert t_sum["hp_completed"] + t_sum["hp_failed_alloc"] == \
        t_sum["hp_generated"]
    assert t_sum["hp_failed_runtime"] == 0
    # greedy decoding from the same weights and prompt: a request done in
    # both runs holds the same tokens, restarted or not
    done = {o[0]: o[4] for o in base if o[1] == "done"}
    for o in t_out:
        if o[1] == "done" and o[0] in done:
            assert o[4] == done[o[0]], o[0]
    restarted = [o[0] for o in t_out if o[1] == "done" and o[3] > 0]
    return t_sum, failures, restarted


@pytest.mark.parametrize("lose_work", [True, False])
def test_engines_agree_under_placed_slice_churn(setup, lose_work):
    events, (base, _), _ = placed_churn(
        lambda hook: _run_script("torch", setup, lose_work,
                                 n_slices=N_SLICES, probe=hook), N_SLICES)
    assert sorted(kind for _, kind, _ in events) == \
        ["drain", "fail", "fail", "rejoin", "rejoin"]
    t_sum, (first, second), restarted = _check_runs(
        setup, lose_work, base, events, N_SLICES)
    # the first failure orphaned an HP request reserved on its slice, the
    # second a running LP decode
    assert any(prio == "HIGH" for _, prio, _ in first[2])
    assert any(prio == "LOW" and was == "running"
               for _, prio, was in second[2])
    assert (t_sum["device_failures"], t_sum["device_drains"],
            t_sum["device_rejoins"]) == (2, 1, 2)
    assert t_sum["orphans_created"] >= 2
    assert set(second[3]) & set(restarted), "no re-placed orphan finished"


def _schedule(pkg_config, pkg_injector, seed):
    return pkg_injector(pkg_config(
        name="serve_churn", n_devices=2, fail_rate=12.0, drain_rate=6.0,
        rejoin_delay=0.04, duration=0.3, seed=seed))


@pytest.mark.parametrize("lose_work", [True, False])
def test_engines_agree_under_injected_slice_churn(setup, lose_work):
    base, _ = _run_script("torch", setup, lose_work)
    inj = _schedule(ChurnConfig, ChurnInjector, seed=SCHEDULE_SEED)
    j_inj = _schedule(JChurnConfig, JChurnInjector, seed=SCHEDULE_SEED)
    assert [dataclasses.astuple(e) for e in inj] == \
        [dataclasses.astuple(e) for e in j_inj]
    assert inj.counts()["fail"] >= 1 and inj.counts()["drain"] >= 1
    events = [(e.t, e.kind, e.device) for e in inj]
    t_sum, _, _ = _check_runs(setup, lose_work, base, events, 2)
    assert t_sum["device_failures"] == inj.counts()["fail"]
