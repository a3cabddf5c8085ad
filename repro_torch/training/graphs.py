"""CUDA graphs of the serving steps: each prompt length's prefill and the
decode step, captured once and replayed.

A prefill or decode step of a dense attention model launches one to two
thousand small kernels, and on the card the host sets their pace.  A
graph replays the same kernels, in the same order, on the same data, in
one launch.  The graphs engage only where the code can see that they
apply (:func:`supported`, :func:`engages`): plain CUDA tensors (no
DTensor, no ``meta``), no capture already under way, and a config whose
every layer is self-attention with a dense FFN, with no encoder and no
modality input.  Everything else runs the eager steps as before.

What a graph reads is held fixed:

- **the weights**, by the addresses of their leaves.  Graphs are kept per
  weight set in a module-level registry, shared by every step object built
  on those weights, and dropped with their memory pool as soon as any
  leaf of the weights is freed (``weakref.finalize``), so that no graph
  outlives, or replays against, freed weights.
- **one resident cache tree** a (weights, config, batch, cache length),
  allocated outside the graphs' pool.  Prefill fills it (no fresh caches a
  prompt: rows past the prompt keep stale K/V under position -1, which
  every kernel skips) and hands out a tree of its tensors; decode reads
  and writes it.  Before a replay overwrites it while the tree last
  handed out is still held (a preempted request's decode state), that
  holder's leaves are re-pointed at copies, so every caller sees what the
  eager step would have given it.  A decode on any other tree runs
  eagerly.
- **static inputs**: the prompt, the token and the position (a 0-d int32
  tensor that the decode kernel reads on the card), written before each
  replay; the next token is copied out of the graph's output after it.

A graph is captured at first sight: the first call of a shape runs
eagerly and its result is returned (that call also allocates the decode
kernel's counters and sets the flash kernel's limits outside capture);
the same call is then captured, and later calls replay.  A replayed step
returns once the card has finished it, its wait opened as an
``engine.read`` span, since every caller reads the result at once.  Each
replay adds one to ``tracing.replays``; the kernel wrappers' ``launches``
count only the kernels launched eagerly.  Replays go on the current
stream, in order, like the eager launches; capture runs nothing.

The registry holds at most ``MAX_TREES`` resident trees and each at most
``MAX_GRAPHS`` graphs, the least recently used going first.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from .. import tracing
from ..kernels import _shard
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..models import model as M
from ..models.config import ModelConfig
from .optimizer import tree_leaves

MAX_TREES = 4           # resident cache trees, each with its graphs
MAX_GRAPHS = 16         # graphs a resident tree keeps: prompt lengths, decode

# the kernel wrappers whose ``launches`` a capture takes back
_COUNTED = (decode_attention, flash_attention)

_trees: OrderedDict = OrderedDict()     # key -> _Resident


def supported(cfg: ModelConfig) -> bool:
    """Every layer of ``cfg`` a kind the graphs take: self-attention (GQA or
    MHA) with a dense FFN, no cross-attention, no encoder, no modality
    input."""
    return (not cfg.encoder_stages and not cfg.modality_embed_dim
            and all(ld.mixer == "attn" and ld.ffn == "dense"
                    and not ld.cross_attn
                    for st in cfg.stages for ld in st.pattern))


def engages(cfg: ModelConfig, device: torch.device) -> bool:
    """The graph path applies to steps of ``cfg`` on ``device`` now."""
    return (device.type == "cuda" and supported(cfg)
            and not torch.cuda.is_current_stream_capturing())


def _weights(params: dict, device: torch.device) -> Optional[tuple]:
    """(address, dtype, shape, strides) of each weight leaf, or None where a
    leaf is a DTensor or lies on another device."""
    out = []
    for t in tree_leaves(params):
        if _shard.is_dtensor(t) or t.device != device:
            return None
        out.append((t.data_ptr(), t.dtype, tuple(t.shape), t.stride()))
    return tuple(out)


def _capture(fn: Callable[[], torch.Tensor], pool):
    """``fn()`` captured in a CUDA graph that shares ``pool`` -> (replay,
    the pool): ``replay()`` runs the graph on the current stream and
    returns ``fn``'s output (the graph's own tensor).  The kernel wrappers'
    ``launches`` count kernels launched to run: the calls made during
    capture, where nothing ran, are taken back, and a replay adds nothing
    to them (``tracing.replays`` counts replays)."""
    before = [k.launches for k in _COUNTED]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        out = fn()
    for k, n in zip(_COUNTED, before):
        k.launches = n

    def replay() -> torch.Tensor:
        graph.replay()
        return out

    return replay, graph.pool()


class _Graph(NamedTuple):
    replay: Callable[[], torch.Tensor]  # runs the graph -> its output
    inputs: tuple                       # its static inputs, written first


def _run(graph: _Graph) -> torch.Tensor:
    """Replay a graph whose inputs are written -> a copy of its output,
    once the card has finished it."""
    out = graph.replay().clone()
    tracing.replays += 1
    if out.is_cuda:
        with tracing.span("engine.read"):
            torch.cuda.current_stream(out.device).synchronize()
    return out


def _mirror(tree: dict) -> dict:
    """New dicts over the same leaves."""
    return {k: _mirror(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _repoint(tree: dict) -> None:
    """Each leaf of ``tree`` replaced, in place, by a copy of itself."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _repoint(v)
        else:
            tree[k] = v.clone()


class _Caches(dict):
    """The caches a prefill hands out: a tree of the resident tensors while
    it is the tree last handed out, of copies once a replay would
    overwrite them.  A dict that can be referenced weakly."""

    __slots__ = ("__weakref__", "resident")


class _Resident:
    """The cache tree, graphs and memory pool of one (weights, config,
    batch, cache length)."""

    def __init__(self, key: tuple, params: dict, cfg: ModelConfig,
                 cache_len: int, device: torch.device):
        self.key = key              # (weights, cfg, batch, cache_len, device)
        self.tree = M.init_caches(cfg, key[2], cache_len, device=device)
        self.graphs: OrderedDict = OrderedDict()  # key -> _Graph
        self.pool = None
        self.holder = None          # weakref of the _Caches last handed out
        self._finalizers = [weakref.finalize(t, _drop, key)
                            for t in tree_leaves(params)]
        for f in self._finalizers:
            f.atexit = False

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()
        self.graphs.clear()

    # -- the tree handed out ------------------------------------------- #
    def holds(self, caches) -> bool:
        return self.holder is not None and self.holder() is caches

    def release(self) -> None:
        """Before the resident tree is overwritten: the tree last handed out,
        where something still holds it, is re-pointed at copies."""
        held = self.holder() if self.holder is not None else None
        self.holder = None
        if held is not None:
            _repoint(held)

    def hand_out(self) -> _Caches:
        out = _Caches(_mirror(self.tree))
        out.resident = weakref.ref(self)
        self.holder = weakref.ref(out)
        return out

    # -- graphs --------------------------------------------------------- #
    def graph(self, key: tuple) -> Optional[_Graph]:
        g = self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
        return g

    def capture(self, key: tuple, fn: Callable[[], torch.Tensor],
                inputs: tuple) -> None:
        replay, self.pool = _capture(fn, self.pool)
        self.graphs[key] = _Graph(replay, inputs)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)


def _drop(key: tuple) -> None:
    res = _trees.pop(key, None)
    if res is not None:
        res.close()


def _resident(key: tuple, params: dict, cfg: ModelConfig,
              cache_len: int, device: torch.device) -> _Resident:
    res = _trees.get(key)
    if res is not None:
        _trees.move_to_end(key)
        return res
    res = _trees[key] = _Resident(key, params, cfg, cache_len, device)
    while len(_trees) > MAX_TREES:
        _trees.popitem(last=False)[1].close()
    return res


def _resident_of(caches) -> Optional[_Resident]:
    """The live resident tree whose last hand-out ``caches`` is."""
    ref = getattr(caches, "resident", None)
    res = ref() if ref is not None else None
    if res is None or _trees.get(res.key) is not res or \
            not res.holds(caches):
        return None
    return res


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: int, run: Callable) -> Optional[tuple]:
    """The prefill of ``tokens`` through its graph -> (next token [B] int32,
    caches), or None where the graphs do not engage.  ``run(tokens,
    caches)`` is the eager step's next token for a prompt, filling
    ``caches``."""
    dev = tokens.device
    weights = _weights(params, dev) if engages(cfg, dev) else None
    if weights is None:
        return None
    res = _resident((weights, cfg, tokens.shape[0], cache_len, dev), params,
                    cfg, cache_len, dev)
    res.release()
    key = ("prefill", tuple(tokens.shape), tokens.dtype)
    g = res.graph(key)
    if g is None:
        static = tokens.clone()
        nxt = run(static, res.tree)
        res.capture(key, lambda: run(static, res.tree), (static,))
    else:
        g.inputs[0].copy_(tokens)
        nxt = _run(g)
    return nxt, res.hand_out()


def decode(params: dict, cfg: ModelConfig, caches, token: torch.Tensor,
           pos, run: Callable) -> Optional[torch.Tensor]:
    """One decode step through the graph -> the next token [B, 1] int32, or
    None where the graphs do not engage: ``caches`` not the tree a prefill
    of these weights last handed out, or ``pos`` a tensor already.
    ``run(token, pos, caches)`` is the eager step's next token at a 0-d
    int32 position."""
    dev = token.device
    if isinstance(pos, torch.Tensor) or not engages(cfg, dev):
        return None
    res = _resident_of(caches)
    if res is None or res.key[1] != cfg or \
            _weights(params, dev) != res.key[0]:
        return None
    key = ("decode", tuple(token.shape), token.dtype)
    g = res.graph(key)
    if g is None:
        tok = token.clone()
        at = torch.full((), int(pos), dtype=torch.int32, device=dev)
        nxt = run(tok, at, res.tree)
        res.capture(key, lambda: run(tok, at, res.tree), (tok, at))
        return nxt
    tok, at = g.inputs
    tok.copy_(token)
    at.fill_(int(pos))
    return _run(g)
