"""The one generator of traffic: it reads a traffic file's parameters and
makes a cell's inputs from ``--seed``.

Serving: a run is a sequence of episodes of ``requests_per_episode``
requests each.  So that a seed changes the order and not the work, every
episode holds the same requests: each class's share and each prompt
length's weight become exact counts (largest remainder), the gaps between
arrivals are the n stratified quantiles of an exponential at
``rate_per_s`` (a Poisson stream's gaps, each drawn once), and the home
slices are balanced; an order permutes each of them.  The orders are a
pool of ``orders`` drawn once from ``order_seed``: episode e of a run
takes order (seed + e) mod ``orders``, so every run whose window holds
that many episodes covers the same orders, and under a scheduler that
preempts and redoes work (``lose_work``) every run does the same work;
the seed picks where the cycle starts, the prompts' tokens and the
weights.

Training: next-token batches of a Zipf unigram stream (``zipf_a``), the
port's data pipeline's distribution, drawn from the seed.
"""
from __future__ import annotations

import numpy as np

SEED_MASK = (1 << 64) - 1


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, *stream])


def exact_counts(n: int, weights: list) -> list:
    """n split by ``weights`` into whole counts (largest remainder)."""
    w = np.asarray(weights, dtype=float)
    raw = n * w / w.sum()
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def episode(traffic: dict, seed: int, index: int, n_slices: int) -> list:
    """The requests of one episode, in arrival order: dicts with ``t``
    (seconds from the episode's start), ``cls`` (the class's name), ``hp``,
    ``prompt_len``, ``new_tokens``, ``home``."""
    order = (int(seed) + index) % traffic["orders"]
    rng = rng_for(traffic["order_seed"], order)
    n = traffic["requests_per_episode"]
    classes = traffic["classes"]
    kinds = []
    for cls, k in zip(classes, exact_counts(n, [c["share"]
                                                for c in classes])):
        for length, m in zip(cls["prompt_lens"],
                             exact_counts(k, cls["weights"])):
            kinds += [(cls, length)] * m
    kinds = [kinds[i] for i in rng.permutation(n)]
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q))           # unit-rate gaps
    times = np.cumsum(gaps) / traffic["arrivals"]["rate_per_s"]
    homes = rng.permutation(np.arange(n) % n_slices)
    return [{"t": float(t), "cls": cls["name"],
             "hp": cls["priority"] == "high", "prompt_len": int(length),
             "new_tokens": int(cls["new_tokens"]), "home": int(h)}
            for t, (cls, length), h in zip(times, kinds, homes)]


def zipf_batches(vocab: int, batch: int, seq: int, zipf_a: float,
                 seed: int):
    """Endless next-token batches {"tokens", "labels"} (int32 numpy) whose
    tokens follow p(k) ~ 1 / (k + 1)^zipf_a; the last label is -1."""
    rng = rng_for(seed, 1 << 20)
    w = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), zipf_a)
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    while True:
        tokens = np.searchsorted(cdf, rng.random((batch, seq)),
                                 side="right").astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((batch, 1), -1, np.int32)], axis=1)
        yield {"tokens": tokens, "labels": labels}


def seed_mix(seed: int, *stream: int) -> int:
    """A 63-bit seed for a torch.Generator from (seed, stream...)."""
    return int(rng_for(seed, *stream).integers(0, 2**63 - 1))

