"""What decides ``correct``, on the CPU: the plain reference against the
port at small sizes, the schedule check, and whole runs with the timed path
broken underneath, each of which has to come out not correct."""
from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import run_cell

from portbench import weights as W
from portbench.reference import dense_decoder as R
from portbench.reference import schedule as S
from portbench.reference import train as RT


def _dims(cfg) -> R.Dims:
    return R.Dims(n_layers=cfg.n_layers, d_model=cfg.d_model,
                  n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
                  vocab_size=cfg.vocab_size, rope_theta=cfg.rope_theta,
                  norm_eps=cfg.norm_eps, tied=cfg.tie_embeddings,
                  window=cfg.sliding_window)


@pytest.mark.parametrize("arch, window", [("qwen2-0.5b", 0),
                                          ("phi3-mini-3.8b", 0),
                                          ("phi3-mini-3.8b", 24)])
def test_reference_matches_the_port_prefill_and_decode(arch, window):
    """The port's prefill and its decode through the cache against the
    reference's full forward pass, on the benchmark's weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke_config(arch), norm_eps=1e-6,
                              sliding_window=window)
    w = W.make_weights(cfg, 2**31 + 5, "cpu")
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 40), generator=g)
    got, caches = M.prefill(w, cfg, {"tokens": prompt}, 48)
    logits = [got[0, -1, : cfg.vocab_size]]
    seq = prompt[0].tolist()
    for pos in range(40, 44):
        tok = int(logits[-1].argmax())
        seq.append(tok)
        out, caches = M.decode_step(w, cfg, caches,
                                    torch.tensor([[tok]]), pos)
        logits.append(out[0, -1, : cfg.vocab_size])
    ref, k, v = R.serve_outputs(w, _dims(cfg), torch.tensor(seq),
                                list(range(39, 44)))
    assert torch.allclose(torch.stack(logits), ref, atol=2e-5, rtol=2e-5)
    # the last layer's cache rows: the prompt's and the 3 decoded tokens'
    from portbench.serve import last_layer_kv
    gk, gv = last_layer_kv(caches, 43)
    assert torch.allclose(gk, k[:43], atol=2e-5, rtol=2e-5)
    assert torch.allclose(gv, v[:43], atol=2e-5, rtol=2e-5)


def test_reference_train_steps_match_the_port():
    from repro_torch.configs import get_smoke_config
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.steps import make_train_step
    cfg = get_smoke_config("qwen2-0.5b")
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "grad_clip": 1.0, "warmup_steps": 1,
           "total_steps": 8, "min_lr_frac": 0.1}
    w = W.make_weights(cfg, 7, "cpu")
    g = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(2):
        t = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
        lab = torch.cat([t[:, 1:], torch.full((2, 1), -1)], 1)
        batches.append({"tokens": t.numpy(), "labels": lab.numpy()})
    ref = RT.run_steps(R, W.make_weights(cfg, 7, "cpu"), _dims(cfg),
                       batches, opt)
    for _, t in RT.leaves(w):
        t.requires_grad_(True)
    ac = AdamWConfig(**opt)
    state = init_opt_state(ac, w)
    step = make_train_step(cfg, ac, remat=True, device="cpu")
    losses = []
    for b in batches:
        w, state, m = step(w, state, b)
        losses.append(float(m["loss"]))
    assert losses == pytest.approx(ref["loss"], rel=1e-6)
    ref_w = W.make_weights(cfg, 7, "cpu")
    for (n, a), (_, b0) in zip(RT.leaves(w), RT.leaves(ref_w)):
        delta = float((a.detach() - b0).norm())
        assert delta == pytest.approx(ref["delta"][n], rel=1e-4, abs=1e-9)


def test_tf32_control_rounds_the_mantissa():
    x = torch.tensor([1.0 + 2.0**-12, 1.0 + 2.0**-10, -(1.0 + 3 * 2.0**-12)])
    y = R._round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2.0**-10, -(1.0 + 2.0**-10)]
    a = torch.randn(16, 32, dtype=torch.float32)
    b = torch.randn(32, 8, dtype=torch.float32)
    p = R.Precision("tf32", torch.device("cpu"))
    err = (p.mm(a, b) - a @ b).abs().max()
    assert 1e-5 < err < 1e-1


def test_tf32_control_fails_the_train_numbers(tiny_root):
    """The reference in TF32 put in the program's place reads above the
    program's own gaps at this small size."""
    from portbench import bench, train
    cell = bench.load_cell("tiny.train", tiny_root / "BENCHMARK.json",
                           tiny_root)
    cfg, p, s, step, batches = train.program(cell, 2**31 + 9, "cpu")
    seen, prog = train.first_steps(p, s, step, batches, 3, 0.9,
                                   torch.device("cpu"))
    ref = train.reference(cell, 2**31 + 9, "cpu", seen)
    low = train.reference(cell, 2**31 + 9, "cpu", seen, "tf32")
    sound, control = train.compare(prog, ref), train.compare(low, ref)
    assert control["grad_gap"] > 10 * sound["grad_gap"]
    assert control["loss_gap"] > 10 * sound["loss_gap"]


def _rec(**kw):
    base = dict(episode=0, rid=1, hp=True, home=0, arrival=0.0,
                deadline=1.0, state="done", completed_at=0.5, tokens=[3],
                max_new_tokens=1, task_type="hp.8", slice=0, units=1,
                t_start=0.1, t_end=0.5, prompt_len=8)
    base.update(kw)
    return base


SLOTS = {"hp.8": {1: 0.4, 2: 0.4, 4: 0.3}, "lp.8": {1: 0.4, 2: 0.6, 4: 0.4}}


@pytest.mark.parametrize("recs, n_faults", [
    ([_rec()], 0),
    ([_rec(completed_at=1.5, t_end=1.5, t_start=1.1)], 1),   # late
    ([_rec(t_start=0.2)], 1),                                 # short slot
    ([_rec(tokens=[])], 1),                                   # no token
    ([_rec(tokens=[999])], 1),                                # off vocab
    ([_rec(slice=1)], 1),                                     # off home
    ([_rec(rid=i, hp=False, units=2, task_type="lp.8", t_start=0.0,
           t_end=0.6, completed_at=0.6, tokens=[1] * 4, max_new_tokens=4)
      for i in range(3)], 1),                                 # 6 units of 4
    ([_rec(rid=i, hp=False, units=2, task_type="lp.8", t_start=0.6 * i,
           t_end=0.6 * (i + 1), completed_at=0.6 * (i + 1),
           deadline=5.0, tokens=[1] * 4, max_new_tokens=4)
      for i in range(3)], 0),                                 # back to back
])
def test_schedule_check(recs, n_faults):
    assert len(S.check(recs, SLOTS, 2, 4, 500)) == n_faults


def test_sound_serving_run_is_correct(tiny_root):
    out = run_cell(tiny_root, "tiny.serve")
    assert out["result"]["correct"], out["checks"]
    assert out["checks"]["schedule_faults"]["value"] == 0
    m = out["result"]["metrics"]
    assert set(m) == {"served_tok_s", "setup_s"}
    assert out["checks"]["judged_tokens"]["value"] == \
        out["checks"]["judged_tokens"]["limit"] > 0


def test_altered_token_makes_a_serving_run_not_correct(tiny_root):
    out = run_cell(tiny_root, "tiny.serve", fault="token")
    assert not out["result"]["correct"]
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("fault", [None, "frozen", "half"])
def test_training_faults_make_a_run_not_correct(tiny_root, fault):
    out = run_cell(tiny_root, "tiny.train", fault=fault, seconds=0.2)
    assert out["result"]["correct"] == (fault is None), out["checks"]
    if fault == "frozen":        # unchanged state reads 1 by the measure
        assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
        assert out["checks"]["delta_gap"]["value"] == pytest.approx(1.0)



def test_tf32_control_fails_the_serving_numbers(tiny_root):
    """The reference in TF32 put in the program's place: its K/V of the
    last layer lie farther from the f32 reference's than the served
    requests' own."""
    from portbench import bench, serve
    cell = bench.load_cell("tiny.serve", tiny_root / "BENCHMARK.json",
                           tiny_root)
    sr = serve.ServeRun(cell, 2**31 + 21, "cpu")
    sr.setup()
    sr.episode(0)
    sr.episodes = 1
    sample = sr.sample()
    sr.free_program(keep=sample)
    _, prog = serve.judge(sr.ref, sr.weights, sr.dims, sample, sr.kv)
    _, ctl = serve.judge(sr.ref, sr.weights, sr.dims, sample, sr.kv,
                         "tf32", control=True)
    assert max(ctl) > 10 * max(max(prog), 1e-7)
    assert max(ctl) > cell.traffic["check"]["kv_rel_err"]
