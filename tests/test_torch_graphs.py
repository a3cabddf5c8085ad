"""The serving steps' CUDA-graph path on the CPU: the decode step at a
position held in a 0-d int32 tensor (what a graph reads at replay) against
the host-int step, bit for bit; which configs take the graphs; and the
resident cache tree's bookkeeping (``training/graphs.py``) with an eager
stand-in for the capture, on the step functions and through the serving
engine.  The graphs themselves run on the card
(``tests/test_torch_graphs_card.py``)."""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.task import Priority
from repro_torch.kernels.decode_attention import decode_attention, \
    decode_attention_ref
from repro_torch.models import model as M
from repro_torch.serving.cost_model import CostModel, PhaseCost
from repro_torch.serving.engine import (
    PreemptiveServingEngine,
    ServeRequest,
    engine_network_config,
)
from repro_torch.training import graphs
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.steps import make_prefill_step, make_serve_step

CACHE_LEN = 12


def _cfg(arch: str, window: int):
    return dataclasses.replace(get_smoke_config(arch), sliding_window=window)


def _tokens(cfg, seed: int, t: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, t)))


# --------------------------------------------------------------------------- #
# The position as a device scalar                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3-mini-3.8b"])
@pytest.mark.parametrize("window", [0, 7])
def test_decode_at_a_tensor_position_is_the_host_int_step(arch, window):
    """GQA (qwen2's smoke heads, 4 over 2) and MHA (phi3's) with no window
    and a window shorter than the cache: from a prompt of 9, decode runs at
    positions before, at and past ``cache_len`` (12), where the rotating
    cache wraps and the full one overwrites its last slot; logits and every
    cache leaf equal the host-int step's bit for bit."""
    cfg = _cfg(arch, window)
    params = M.init_params(cfg, 3, device="cpu")
    prompt = _tokens(cfg, 4, 9)
    with torch.inference_mode():
        _, host = M.prefill(params, cfg, {"tokens": prompt}, CACHE_LEN)
        _, dev = M.prefill(params, cfg, {"tokens": prompt}, CACHE_LEN)
        tok = prompt[:, -1:]
        for pos in range(9, 16):
            want, _ = M.decode_step(params, cfg, host, tok, pos)
            got, _ = M.decode_step(params, cfg, dev, tok,
                                   torch.tensor(pos, dtype=torch.int32))
            assert torch.equal(got, want), pos
            for a, b in zip(tree_leaves(dev), tree_leaves(host)):
                assert torch.equal(a, b), pos
            tok = want[:, -1, :cfg.vocab_size].argmax(-1)[:, None]


@pytest.mark.parametrize("window", [0, 5])
def test_decode_reference_takes_a_tensor_position(window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 8), generator=g)
    k = torch.randn((2, 10, 2, 8), generator=g)
    v = torch.randn((2, 10, 2, 8), generator=g)
    positions = torch.tensor([list(range(10)), [3, -1, 5, 9, 0, 1, 2, -1, 8,
                                                 7]], dtype=torch.int32)
    for pos in (0, 4, 9, 14):
        want = decode_attention_ref(q, k, v, positions, pos, window=window)
        for at in (torch.tensor(pos, dtype=torch.int32), torch.tensor(pos)):
            assert torch.equal(decode_attention_ref(q, k, v, positions, at,
                                                    window=window), want)
            # the wrapper's CPU tensors take the plain version
            assert torch.equal(decode_attention(q, k, v, positions, at,
                                                window=window), want)


# --------------------------------------------------------------------------- #
# Which configs take the graphs                                               #
# --------------------------------------------------------------------------- #


TAKES_GRAPHS = {"qwen2-0.5b": True, "smollm-135m": True,
                "phi3-mini-3.8b": True, "deepseek-7b": True,
                "llava-next-34b": False, "seamless-m4t-medium": False,
                "deepseek-v2-236b": False, "deepseek-v3-671b": False,
                "jamba-1.5-large-398b": False, "xlstm-1.3b": False}


@pytest.mark.parametrize("arch", sorted(TAKES_GRAPHS))
def test_graphs_take_dense_attention_configs_by_their_layers(arch):
    """Decided from the layer descriptors (attention with a dense FFN, no
    encoder, no modality input), never from a name: a renamed config keeps
    its answer."""
    cfg = get_config(arch)
    assert graphs.supported(cfg) is TAKES_GRAPHS[arch]
    assert graphs.supported(dataclasses.replace(cfg, name="renamed")) is \
        TAKES_GRAPHS[arch]


def test_cpu_steps_stay_eager():
    """On the CPU the graph path never engages: nothing is registered,
    nothing replayed, and the caches are the eager step's own."""
    cfg = get_smoke_config("qwen2-0.5b")
    params = M.init_params(cfg, 0, device="cpu")
    pre = make_prefill_step(cfg, CACHE_LEN, device="cpu")
    srv = make_serve_step(cfg, device="cpu")
    before = tracing.replays
    nxt, caches = pre(params, {"tokens": _tokens(cfg, 1, 6)})
    srv(params, caches, nxt[:, None], 6)
    assert not graphs.engages(cfg, torch.device("cpu"))
    assert type(caches) is dict and not graphs._trees
    assert tracing.replays == before


# --------------------------------------------------------------------------- #
# The resident tree, with an eager stand-in for the capture                   #
# --------------------------------------------------------------------------- #


def _standin(monkeypatch) -> list:
    """The graph path on the CPU: engaged for the configs it takes, and a
    capture that records the step's function, which each replay calls
    again on the static inputs.  -> the trees re-pointed at copies."""
    monkeypatch.setattr(graphs, "_trees", OrderedDict())
    monkeypatch.setattr(graphs, "engages",
                        lambda cfg, device: graphs.supported(cfg))
    monkeypatch.setattr(graphs, "_capture", lambda fn, pool: (fn, pool))
    repointed = []
    repoint = graphs._repoint

    def spy(tree):
        if isinstance(tree, graphs._Caches):     # not its nested dicts
            repointed.append(tree)
        repoint(tree)

    monkeypatch.setattr(graphs, "_repoint", spy)
    return repointed


@pytest.fixture
def standin(monkeypatch):
    return _standin(monkeypatch)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_smoke_config("qwen2-0.5b")
    return cfg, M.init_params(cfg, 0, device="cpu")


def _eager(cfg, params, prompt, n_tokens):
    """Tokens and caches of the plain steps: the prefill, then n decodes."""
    with torch.inference_mode():
        logits, caches = M.prefill(params, cfg, {"tokens": prompt},
                                   CACHE_LEN)
        toks = [logits[:, -1, :cfg.vocab_size].argmax(-1).to(torch.int32)]
        for i in range(n_tokens):
            logits, _ = M.decode_step(params, cfg, caches, toks[-1][:, None],
                                      prompt.shape[1] + i)
            toks.append(logits[:, -1, :cfg.vocab_size].argmax(-1)
                        .to(torch.int32))
    return toks, caches


def test_replays_follow_the_eager_steps(standin, tiny):
    """First sight runs eagerly and captures; later calls replay the
    recorded step on the static inputs: each prompt and position gives the
    eager tokens and caches."""
    cfg, params = tiny
    pre = make_prefill_step(cfg, CACHE_LEN, device="cpu")
    srv = make_serve_step(cfg, device="cpu")
    before = tracing.replays
    for seed in (1, 2, 3):
        prompt = _tokens(cfg, seed, 6)
        want, want_caches = _eager(cfg, params, prompt, 3)
        nxt, caches = pre(params, {"tokens": prompt})
        got = [nxt]
        for i in range(3):
            nxt, caches = srv(params, caches, got[-1][:, None], 6 + i)
            got.append(nxt[:, 0])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(caches), tree_leaves(want_caches)))
        del caches                      # let go before the next prefill
    # the first prefill and the first decode were captured, not replayed
    assert tracing.replays - before == 3 * 4 - 2
    assert not standin                  # no earlier tree was still held
    (res,) = graphs._trees.values()
    assert sorted(k[0] for k in res.graphs) == ["decode", "prefill"]


def test_a_held_tree_is_copied_out_before_it_is_overwritten(standin, tiny):
    """A caller that still holds the tree a prefill handed out keeps its
    contents when a later prefill overwrites the resident tensors: its
    leaves are re-pointed at copies, and a decode on it runs eagerly,
    giving the eager tokens.  A tree no longer held is not copied."""
    cfg, params = tiny
    pre = make_prefill_step(cfg, CACHE_LEN, device="cpu")
    srv = make_serve_step(cfg, device="cpu")
    a, b = _tokens(cfg, 5, 6), _tokens(cfg, 6, 6)
    want_a, want_caches_a = _eager(cfg, params, a, 2)
    nxt_a, caches_a = pre(params, {"tokens": a})
    nxt_a, caches_a = srv(params, caches_a, nxt_a[:, None], 6)
    resident = [t.data_ptr() for t in tree_leaves(caches_a)]
    held = [t.clone() for t in tree_leaves(caches_a)]
    pre(params, {"tokens": b})          # overwrites the resident tree
    assert standin == [caches_a]
    for t, ptr, old in zip(tree_leaves(caches_a), resident, held):
        assert t.data_ptr() != ptr and torch.equal(t, old)
    before = tracing.replays
    nxt_a, caches_a = srv(params, caches_a, nxt_a, 7)      # eager
    assert tracing.replays == before
    assert torch.equal(nxt_a[:, 0], want_a[2])
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(caches_a), tree_leaves(want_caches_a)))
    # the tree of b was let go: the next prefill copies nothing
    del standin[:]
    pre(params, {"tokens": a})
    assert standin == []


def _engine(cfg, params, lose_work):
    """LP work that fills slice 0 at t=0, HP requests at 0.01 and 0.03 that
    preempt it, and LP work offloadable from slice 1."""
    cost = CostModel()
    cost.prefill[1] = PhaseCost(0.05, 0.005)
    cost.decode[2] = PhaseCost(0.02, 0.002)
    cost.decode[4] = PhaseCost(0.014, 0.0014)
    net = engine_network_config(cost, 4)
    eng = PreemptiveServingEngine(cfg, params, cost, device="cpu",
                                  n_slices=2, units_per_slice=4, net=net,
                                  lose_work=lose_work, cache_len=CACHE_LEN)
    reqs = [(0.0, ServeRequest(prompt=_tokens(cfg, i + 2, 5)[:1],
                               max_new_tokens=4, priority=Priority.LOW,
                               deadline=120.0, home_slice=0))
            for i in range(4)]
    reqs += [(at, ServeRequest(prompt=_tokens(cfg, 40 + i, 5)[:1],
                               max_new_tokens=1, priority=Priority.HIGH,
                               deadline=at + net.t_hp * 2 + 0.2,
                               home_slice=0))
             for i, at in enumerate((0.01, 0.03))]
    reqs.append((0.0, ServeRequest(prompt=_tokens(cfg, 60, 5)[:1],
                                   max_new_tokens=3, priority=Priority.LOW,
                                   deadline=60.0, home_slice=1)))
    for at, r in reqs:
        eng.q.push(at, lambda r=r: eng.submit(r))
    return eng, [r for _, r in reqs]


def _outcomes(reqs):
    return [(r.state, r.completed_at, r.n_preemptions, list(r.tokens_out),
             r.task.device, r.task.cores, r.task.t_start, r.task.t_end)
            for r in reqs]


@pytest.mark.parametrize("lose_work", [False, True])
def test_engine_outcomes_with_the_graph_path(monkeypatch, tiny, lose_work):
    """The same requests, preempted LP requests among them, through the
    engine with the eager steps and with the graph path (its stand-in):
    the same outcomes and tokens.  With ``lose_work=False`` a preempted
    request's resident caches are still held when the next prefill comes,
    and are copied out; every step is counted on its request, the replays
    among them."""
    cfg, params = tiny
    eng, reqs = _engine(cfg, params, lose_work)
    eng.run()
    want = _outcomes(reqs)
    want_steps = [r.steps for r in reqs]
    assert any(r.n_preemptions for r in reqs)
    assert sum(want_steps) > 2 and all(r.replays == 0 for r in reqs)

    repointed = _standin(monkeypatch)
    eng, reqs = _engine(cfg, params, lose_work)
    eng.run()
    assert _outcomes(reqs) == want
    assert [r.steps for r in reqs] == want_steps
    # held only where a preempted attempt may resume from its caches
    assert bool(repointed) is not lose_work
    # one prompt length: a prefill and a decode graph captured at their
    # first sight, every other step replayed
    assert sum(r.replays for r in reqs) == sum(want_steps) - 2


# --------------------------------------------------------------------------- #
# The counters of replayed steps                                              #
# --------------------------------------------------------------------------- #


def test_graph_replay_share_reads_the_requests_counters(monkeypatch, tiny):
    """The share of replayed steps that the engine's requests record: each
    request counts its steps and, by ``tracing.replays``, the replays among
    them; none eager on the CPU, all but the two captured steps through
    the stand-in."""
    cfg, params = tiny
    for graphed in (False, True):
        if graphed:
            _standin(monkeypatch)
        before = tracing.replays
        eng, reqs = _engine(cfg, params, lose_work=True)
        eng.run()
        steps = sum(r.steps for r in reqs)
        replays = sum(r.replays for r in reqs)
        assert all(0 <= r.replays <= r.steps for r in reqs)
        assert steps > 2 and replays == tracing.replays - before
        assert replays / steps == ((steps - 2) / steps if graphed else 0.0)
