"""The port's PreemptiveServingEngine on ``device="cpu"``: a twin of
tests/test_serving_engine.py, and the same request scripts driven through
both engines, which must agree on every per-request outcome and on the
metrics summary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.task as jax_task
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.task import Priority as JPriority
from repro.models import model as JM
from repro.serving import cost_model as jax_cost
from repro.serving import engine as jax_engine
import repro_torch.core.task as torch_task
from repro_torch.configs import get_smoke_config
from repro_torch.core.task import Priority
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.cost_model import CostModel, PhaseCost, \
    analytic_cost_model, measure_cost_model
from repro_torch.serving.engine import (
    PreemptiveServingEngine,
    ServeRequest,
    engine_network_config,
    validate_submission,
)


def _setup(arch):
    jcfg = jax_smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    # synthetic cost model (fast, deterministic; no timing needed)
    cost = CostModel()
    cost.prefill[1] = PhaseCost(0.05, 0.005)
    cost.decode[2] = PhaseCost(0.02, 0.002)
    cost.decode[4] = PhaseCost(0.014, 0.0014)
    return cfg, params, cost, jcfg, jparams


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen2-0.5b")


@pytest.fixture(scope="module")
def xlstm_setup():
    return _setup("xlstm-1.3b")


@pytest.fixture(scope="module")
def deepseek_v2_setup():
    return _setup("deepseek-v2-236b")


@pytest.fixture(scope="module")
def jamba_setup():
    return _setup("jamba-1.5-large-398b")


SETUPS = {"qwen2-0.5b": "setup", "xlstm-1.3b": "xlstm_setup",
          "deepseek-v2-236b": "deepseek_v2_setup",
          "jamba-1.5-large-398b": "jamba_setup"}


def _engine(cfg, params, cost, lp_tokens=6, **kw):
    net = engine_network_config(cost, lp_tokens)
    return PreemptiveServingEngine(cfg, params, cost, device="cpu",
                                   n_slices=2, units_per_slice=4, net=net,
                                   **kw), net


def _prompt_np(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 8)).astype(np.int32)


def _prompt(cfg, seed=1):
    return torch.from_numpy(_prompt_np(cfg, seed))


# --------------------------------------------------------------------------- #
# Twin of tests/test_serving_engine.py                                        #
# --------------------------------------------------------------------------- #


def test_engine_network_config_carries_workload_spec(setup):
    cfg, params, cost, *_ = setup
    net = engine_network_config(cost, 10)
    prof = net.profile()
    assert prof.name == "serve"
    assert prof.lp_exec[2] == pytest.approx(0.2)
    assert prof.lp_exec[4] == pytest.approx(0.14)
    assert prof.lp_pad[2] == pytest.approx(0.02)
    assert prof.lp_pad[4] == pytest.approx(0.014)
    assert net.t_hp == prof.hp_exec
    assert net.t_lp_2core == prof.lp_exec[2]
    assert net.t_lp_4core == prof.lp_exec[4]


def test_hp_request_completes_within_deadline(setup):
    cfg, params, cost, *_ = setup
    eng, net = _engine(cfg, params, cost)
    req = ServeRequest(prompt=_prompt(cfg), max_new_tokens=1,
                       priority=Priority.HIGH, deadline=net.t_hp * 3 + 1.0,
                       home_slice=0)
    eng.submit(req)
    m = eng.run()
    assert req.state == "done"
    assert req.completed_at <= req.deadline + 1e-9
    assert m.hp_completed == 1
    assert len(req.tokens_out) == 1          # real compute happened


def test_lp_generates_requested_tokens(setup):
    cfg, params, cost, *_ = setup
    eng, net = _engine(cfg, params, cost, lp_tokens=5)
    req = ServeRequest(prompt=_prompt(cfg), max_new_tokens=5,
                       priority=Priority.LOW, deadline=60.0, home_slice=1)
    eng.submit(req)
    eng.run()
    assert req.state == "done"
    assert len(req.tokens_out) == 5
    assert all(0 <= t < cfg.vocab_size for t in req.tokens_out)


def test_hp_preempts_saturating_lp(setup):
    cfg, params, cost, *_ = setup
    for preemption, expect in ((True, "done"), (False, "failed")):
        eng, net = _engine(cfg, params, cost, preemption=preemption)
        lps = []
        for i in range(4):                  # 4 x 2-core >= 4-unit slice
            lp = ServeRequest(prompt=_prompt(cfg, i + 2), max_new_tokens=4,
                              priority=Priority.LOW, deadline=120.0,
                              home_slice=0)
            lps.append(lp)
            eng.submit(lp)
        hp = ServeRequest(prompt=_prompt(cfg), max_new_tokens=1,
                          priority=Priority.HIGH,
                          deadline=net.t_hp * 2 + 0.2, home_slice=0)
        eng.q.push(0.01, lambda r=hp: eng.submit(r))
        m = eng.run()
        assert hp.state == expect, (preemption, hp.state)
        if preemption:
            assert m.preemptions >= 1
            assert any(lp.n_preemptions > 0 for lp in lps)


def test_resume_mode_keeps_partial_decode(setup):
    cfg, params, cost, *_ = setup
    eng, net = _engine(cfg, params, cost, preemption=True, lose_work=False)
    victim = ServeRequest(prompt=_prompt(cfg, 5), max_new_tokens=4,
                          priority=Priority.LOW, deadline=120.0, home_slice=0)
    eng.submit(victim)
    eng.run()
    assert victim.state == "done"
    assert victim.rid not in eng._decode_state


def test_engine_drives_registered_policy(setup):
    cfg, params, cost, *_ = setup
    net = engine_network_config(cost, 4)
    eng = PreemptiveServingEngine(cfg, params, cost, device="cpu",
                                  n_slices=2, units_per_slice=4, net=net,
                                  policy="edf_only")
    hp = ServeRequest(prompt=_prompt(cfg), max_new_tokens=1,
                      priority=Priority.HIGH, deadline=net.t_hp * 3 + 1.0,
                      home_slice=0)
    lp = ServeRequest(prompt=_prompt(cfg, 8), max_new_tokens=4,
                      priority=Priority.LOW, deadline=60.0, home_slice=1)
    eng.submit(hp)
    eng.submit(lp)
    m = eng.run()
    assert hp.state == "done" and lp.state == "done"
    assert len(lp.tokens_out) == 4
    assert m.hp_completed == 1 and m.lp_completed == 1
    assert m.preemptions == 0            # edf_only never preempts


def test_submit_batch_admits_lp_burst(setup):
    cfg, params, cost, *_ = setup
    eng, net = _engine(cfg, params, cost, lp_tokens=3)
    lps = [ServeRequest(prompt=_prompt(cfg, i + 20), max_new_tokens=3,
                        priority=Priority.LOW, deadline=300.0,
                        home_slice=i % 2)
           for i in range(4)]
    hp = ServeRequest(prompt=_prompt(cfg, 30), max_new_tokens=1,
                      priority=Priority.HIGH, deadline=net.t_hp * 3 + 1.0,
                      home_slice=0)
    eng.submit_batch(lps + [hp])
    m = eng.run()
    assert hp.state == "done"
    assert [r.state for r in lps] == ["done"] * 4
    assert all(len(r.tokens_out) == 3 for r in lps)
    assert m.lp_requests_total == 4 and m.lp_allocated == 4
    assert m.lp_completed == 4 and m.hp_completed == 1


def test_execution_driving_policy_is_rejected(setup):
    cfg, params, cost, *_ = setup
    with pytest.raises(ValueError, match="slot-based policy"):
        PreemptiveServingEngine(cfg, params, cost, device="cpu",
                                policy="central_ws")


def test_submission_is_validated(setup):
    cfg, params, cost, *_ = setup
    eng, net = _engine(cfg, params, cost)
    bad = ServeRequest(prompt=_prompt(cfg), max_new_tokens=0,
                       priority=Priority.LOW, deadline=5.0, home_slice=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(bad)
    with pytest.raises(ValueError, match="priority"):
        validate_submission(priority=JPriority.HIGH, deadline=1.0)
    with pytest.raises(ValueError, match="past"):
        validate_submission(priority=Priority.HIGH, deadline=0.0)


def test_measure_cost_model_on_cpu():
    cfg = get_smoke_config("smollm-135m")
    cm = measure_cost_model(cfg, prompt_len=8, cache_len=16, reps=2,
                            degrees=(2, 4), device="cpu")
    assert cm.degrees == (2, 4)
    assert cm.prefill[1].mean_s > 0 and cm.decode[2].mean_s > 0
    # every doubling applies the paper's 2-core:4-core ratio
    assert cm.decode[4].mean_s == pytest.approx(
        cm.decode[2].mean_s * 11.611 / 16.862)
    with pytest.raises(ValueError, match="duplicate"):
        measure_cost_model(cfg, degrees=(2, 2), device="cpu")


def test_analytic_cost_model_matches_jax():
    a = analytic_cost_model({2: 0.02, 4: 0.014}, prefill_s=0.05)
    b = jax_cost.analytic_cost_model({2: 0.02, 4: 0.014}, prefill_s=0.05)
    assert a.prefill[1].padded == b.prefill[1].padded
    assert a.lp_slot_time(4, 10) == b.lp_slot_time(4, 10)


# --------------------------------------------------------------------------- #
# Cross-engine: the same script through both packages                         #
# --------------------------------------------------------------------------- #


def _script(cfg, n_lp=4):
    """(arrival, kwargs) of a burst that saturates slice 0 with LP work,
    then tight-deadline HP requests that must preempt, plus offloadable LP
    work on slice 1."""
    out = []
    rid = 1000
    for i in range(n_lp):
        out.append((0.0, dict(seed=i + 2, max_new_tokens=4, hp=False,
                              deadline=120.0, home_slice=0, rid=rid)))
        rid += 1
    for i, at in enumerate((0.01, 0.03, 0.2)):
        out.append((at, dict(seed=40 + i, max_new_tokens=1, hp=True,
                             deadline=None, home_slice=i % 2, rid=rid)))
        rid += 1
    for i in range(n_lp - 1):
        out.append((0.05 * i, dict(seed=60 + i, max_new_tokens=3, hp=False,
                                   deadline=60.0, home_slice=1, rid=rid)))
        rid += 1
    return out


def _run_script(kind, setup, lose_work, n_lp=4):
    cfg, params, cost, jcfg, jparams = setup
    if kind == "jax":
        jax_task.reset_id_counters()
        jcost = jax_cost.CostModel(prefill=dict(cost.prefill),
                                   decode=dict(cost.decode))
        net = jax_engine.engine_network_config(jcost, 4)
        eng = jax_engine.PreemptiveServingEngine(
            jcfg, jparams, jcost, n_slices=2, units_per_slice=4, net=net,
            lose_work=lose_work)
        serve_request, prio, mk = jax_engine.ServeRequest, JPriority, \
            jnp.asarray
    else:
        torch_task.reset_id_counters()
        net = engine_network_config(cost, 4)
        eng = PreemptiveServingEngine(
            cfg, params, cost, device="cpu", n_slices=2, units_per_slice=4,
            net=net, lose_work=lose_work)
        serve_request, prio, mk = ServeRequest, Priority, torch.from_numpy
    reqs = []
    for at, kw in _script(cfg, n_lp):
        hp = kw["hp"]
        deadline = kw["deadline"] or at + net.t_hp * 2 + 0.2
        req = serve_request(
            prompt=mk(_prompt_np(cfg, kw["seed"])),
            max_new_tokens=kw["max_new_tokens"],
            priority=prio.HIGH if hp else prio.LOW, deadline=deadline,
            home_slice=kw["home_slice"], rid=kw["rid"])
        reqs.append(req)
        eng.q.push(at, lambda r=req: eng.submit(r))
    m = eng.run()
    outcome = [(r.rid, r.state, r.completed_at, r.n_preemptions,
                list(r.tokens_out)) for r in reqs]
    return outcome, m.summary()


# Host wall-clock latencies of the scheduler's own decisions: measured, so
# they differ from run to run even within one engine.
WALL_CLOCK_KEYS = {"t_hp_initial_ms", "t_hp_preempt_ms", "t_lp_alloc_ms",
                   "t_realloc_ms"}


def _virtual(summary):
    return {k: v for k, v in summary.items() if k not in WALL_CLOCK_KEYS}


@pytest.mark.parametrize("arch,lose_work,n_lp", [
    pytest.param("qwen2-0.5b", True, 4, id="True"),
    pytest.param("qwen2-0.5b", False, 4, id="False"),
    # a few requests: 3 LP on slice 0, 3 HP that preempt, 2 offloadable LP
    pytest.param("xlstm-1.3b", True, 3, id="xlstm-1.3b-True"),
    # MLA + MoE, and Mamba + attention + MoE (default capacity)
    pytest.param("deepseek-v2-236b", True, 3, id="deepseek-v2-236b-True"),
    pytest.param("jamba-1.5-large-398b", True, 3,
                 id="jamba-1.5-large-398b-True"),
])
def test_engines_agree_on_outcomes_and_metrics(request, arch, lose_work,
                                               n_lp):
    setup = request.getfixturevalue(SETUPS[arch])
    j_out, j_sum = _run_script("jax", setup, lose_work, n_lp)
    t_out, t_sum = _run_script("torch", setup, lose_work, n_lp)
    assert t_out == j_out
    assert t_sum.keys() == j_sum.keys()
    assert _virtual(t_sum) == _virtual(j_sum)
    # the script exercises preemption and real decode
    assert j_sum["preemptions"] >= 1
    assert any(len(o[4]) > 1 for o in t_out)
