"""Random weights of a dense decoder, made by the benchmark from the seed.

The benchmark makes the weights (an input, like the prompts) and hands the
same tensors to the port and to the plain reference.  The tree has the
port's layout, read from ``repro_torch.models.model.abstract_params`` (meta
tensors: shapes only); every leaf is drawn on the device by one
``torch.Generator`` in one call a leaf (a stage's layers are one stacked
leaf), in sorted key order, so the same seed gives the same weights.
Norm scales and biases are random too, so the reference checks that each
is applied.
"""
from __future__ import annotations

import torch

SEED_MASK = (1 << 63) - 1


def _paths(tree: dict, prefix: tuple = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(layout: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Fill ``layout`` (a tree of tensors or meta tensors giving shapes)
    with values drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    out: dict = {}
    for path, leaf in _paths(layout):
        shape = tuple(leaf.shape)
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(generator=gen)
        name = path[-1]
        if name == "scale":                        # norm scales
            t.mul_(0.1).add_(1.0)
        elif name in ("bq", "bk", "bv"):           # projection biases
            t.mul_(0.1)
        elif name == "embed":
            t.mul_(0.02)
        else:                                      # [(layers,) in, ...]
            fan_in = shape[1] if path[0].startswith("dec") else shape[0]
            t.mul_(fan_in ** -0.5)
        _set(out, path, t if dtype == torch.float32 else t.to(dtype))
    return out


def make_weights(cfg, seed: int, device) -> dict:
    """The port's param tree for ``cfg`` with the benchmark's values."""
    from repro_torch.models.model import abstract_params
    return draw(abstract_params(cfg), seed, device,
                getattr(torch, cfg.param_dtype))
