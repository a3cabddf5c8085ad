"""The serving steps' CUDA graphs (``training/graphs.py``) on the card: graph
prefill and decode against the eager steps bit for bit, the serving engine
with the graphs on and off, a decode graph replayed between eager decode
launches (which share the decode kernel's ticket counters), and the graphs
freed with the weights they captured.  Every test needs a CUDA card and
skips without one; on a card:

    python -m pytest -q -m card tests/test_torch_graphs_card.py
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.task import Priority
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import model as M
from repro_torch.models.config import StageDef
from repro_torch.serving.cost_model import CostModel, PhaseCost, \
    measure_cost_model
from repro_torch.serving.engine import (
    PreemptiveServingEngine,
    ServeRequest,
    engine_network_config,
)
from repro_torch.training import graphs
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.steps import make_prefill_step, make_serve_step

pytestmark = pytest.mark.card

LAYERS = 2


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cut(arch: str, **fields):
    """``arch`` at full width with its decoder cut to LAYERS layers."""
    cfg = get_config(arch)
    (st,) = cfg.stages
    return dataclasses.replace(
        cfg, n_layers=LAYERS, stages=(StageDef(st.pattern, LAYERS),),
        **fields)


# qwen2's GQA at T up to 1024 with no window; phi3's MHA (hd 96) at the
# benchmark's window 2047 over a cache of 2044, where decode past the
# prompt's 2040 tokens rotates
SHAPES = {"qwen2": ("qwen2-0.5b", {}, 1100, (16, 100, 1024)),
          "phi3": ("phi3-mini-3.8b", {"sliding_window": 2047}, 2044,
                   (16, 512, 2040))}


def _eager_off(monkeypatch):
    monkeypatch.setattr(graphs, "engages", lambda cfg, device: False)


def _run(cfg, params, cache_len, prompts, n_tokens):
    """Each prompt's prefill and n decode steps through fresh step objects
    -> [(tokens, copies of the caches' leaves)] a prompt."""
    pre = make_prefill_step(cfg, cache_len, device="cuda")
    srv = make_serve_step(cfg, device="cuda")
    out = []
    for prompt in prompts:
        nxt, caches = pre(params, {"tokens": prompt})
        toks = [int(nxt[0])]
        last = nxt[:, None]
        for i in range(n_tokens):
            last, caches = srv(params, caches, last, prompt.shape[1] + i)
            toks.append(int(last[0, 0]))
        out.append((toks, [t.clone() for t in tree_leaves(caches)]))
        del caches
    return out


def _same_caches(got: list, want: list) -> None:
    """Leaf for leaf (sorted keys: k, positions, v of each layer slot):
    the positions equal; K and V equal wherever a position is stored.  The
    resident tree keeps stale rows under position -1 past a shorter
    prompt, where fresh caches hold zeros; no kernel reads them."""
    for i in range(0, len(want), 3):
        k, pos, v = got[i:i + 3]
        wk, wpos, wv = want[i:i + 3]
        assert torch.equal(pos, wpos)
        rows = (wpos >= 0)[..., None, None]
        assert torch.equal(torch.where(rows, k, 0), torch.where(rows, wk, 0))
        assert torch.equal(torch.where(rows, v, 0), torch.where(rows, wv, 0))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_graph_steps_equal_the_eager_steps(card, monkeypatch, shape):
    """Every prompt twice (captured at first sight, then replayed) and 6
    decode tokens after each: the tokens and the caches after the decodes
    equal the eager steps' bit for bit.  The kernels' ``launches`` count
    the eager first sights alone (a capture's are taken back) and
    ``tracing.replays`` every other step."""
    arch, fields, cache_len, lengths = SHAPES[shape]
    cfg = _cut(arch, **fields)
    params = M.init_params(cfg, 0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (1, t), generator=gen,
                             device="cuda") for t in lengths]
    prompts = prompts + prompts[::-1]
    with monkeypatch.context() as m:
        _eager_off(m)
        want = _run(cfg, params, cache_len, prompts, 6)
    before = (flash_attention.launches, decode_attention.launches,
              tracing.replays)
    got = _run(cfg, params, cache_len, prompts, 6)
    assert (flash_attention.launches - before[0],
            decode_attention.launches - before[1]) == \
        (LAYERS * len(lengths), LAYERS)
    assert tracing.replays - before[2] == \
        len(prompts) - len(lengths) + 6 * len(prompts) - 1
    for (toks, caches), (wtoks, wcaches) in zip(got, want):
        assert toks == wtoks
        _same_caches(caches, wcaches)
    dev = params["embed"].device
    (res,) = [r for r in graphs._trees.values()
              if r.key[0] == graphs._weights(params, dev)]
    assert len(res.graphs) == len(lengths) + 1


def _requests(cfg, gen):
    reqs = []
    for i in range(16):
        hp = i % 3 != 2
        t = (64, 200, 512)[i % 3]
        reqs.append((0.02 * i, ServeRequest(
            prompt=torch.randint(0, cfg.vocab_size, (1, t), generator=gen,
                                 device="cuda"),
            max_new_tokens=1 if hp else 4,
            priority=Priority.HIGH if hp else Priority.LOW,
            deadline=0.02 * i + (0.2 if hp else 1.0), home_slice=i % 4)))
    return reqs


@pytest.mark.parametrize("lose_work", [True, False])
def test_engine_outcomes_with_the_graphs_on_and_off(card, monkeypatch,
                                                    lose_work):
    """The same requests through ``PreemptiveServingEngine`` with the eager
    steps and with the graphs: identical tokens and outcomes, and most
    steps replayed."""
    cfg = _cut("qwen2-0.5b")
    params = M.init_params(cfg, 0, device="cuda")
    cost = CostModel()
    cost.prefill[1] = PhaseCost(0.03, 0.003)
    cost.decode[2] = PhaseCost(0.01, 0.001)
    cost.decode[4] = PhaseCost(0.007, 0.0007)
    net = engine_network_config(cost, 4)

    def run():
        eng = PreemptiveServingEngine(cfg, params, cost, device="cuda",
                                      lose_work=lose_work, cache_len=520,
                                      net=net)
        reqs = _requests(cfg, torch.Generator(device="cuda").manual_seed(3))
        for at, r in reqs:
            eng.q.push(at, lambda r=r: eng.submit(r))
        eng.run()
        return [(r.state, r.completed_at, r.n_preemptions,
                 list(r.tokens_out)) for _, r in reqs], \
            [r for _, r in reqs]

    with monkeypatch.context() as m:
        _eager_off(m)
        want, eager = run()
    got, reqs = run()
    assert got == want
    assert sum(r.replays for r in eager) == 0
    steps = sum(r.steps for r in reqs)
    assert steps == sum(r.steps for r in eager)
    assert sum(r.replays for r in reqs) >= steps - 4   # 3 lengths, decode


def test_decode_graph_between_eager_decode_launches(card):
    """1,000 replays of a decode graph, each followed by an eager launch of
    the decode kernel on other tensors: both outputs stay what they were
    (the launches share the kernel's ticket counters, and leave them at
    0)."""
    cfg = _cut("qwen2-0.5b")
    params = M.init_params(cfg, 0, device="cuda")
    pre = make_prefill_step(cfg, 600, device="cuda")
    srv = make_serve_step(cfg, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4))
    nxt, caches = pre(params, {"tokens": prompt})
    first, _ = srv(params, caches, nxt[:, None], 300)      # captured
    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((1, 14, 64), generator=g, device="cuda")
    kv = torch.randn((1, 4096, 2, 64), generator=g, device="cuda")
    positions = torch.arange(4096, dtype=torch.int32,
                             device="cuda")[None].contiguous()
    other = decode_attention(q, kv, kv, positions, 3000)
    for _ in range(1000):
        again, _ = srv(params, caches, nxt[:, None], 300)
        assert torch.equal(again, first)
        assert torch.equal(decode_attention(q, kv, kv, positions, 3000),
                           other)
    torch.cuda.synchronize()
    for t in decode_ops._counters.values():
        assert int(t.count_nonzero()) == 0


def test_weights_freed_free_their_graphs(card):
    """``measure_cost_model`` draws its own weights and captures both steps
    on them: once it returns, their resident trees, graphs and pools are
    gone, and the device memory allocated is what it was."""
    cfg = _cut("qwen2-0.5b")
    kw = dict(prompt_len=1024, cache_len=4100, reps=2, device="cuda")
    measure_cost_model(cfg, **kw)             # builds, counters, workspaces
    gc.collect()
    torch.cuda.synchronize()
    n_trees = len(graphs._trees)
    before = torch.cuda.memory_allocated()
    cost = measure_cost_model(cfg, seed=1, **kw)
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert np.isfinite(cost.prefill[1].mean_s)
    assert len(graphs._trees) == n_trees
    assert after == before, after - before
