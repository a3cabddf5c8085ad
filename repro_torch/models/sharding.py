"""Logical-axis -> mesh-axis sharding rules with divisibility fallback, and
their placements on a ``torch.distributed`` ``DeviceMesh``.

Port of the JAX package's ``models/sharding.py``.  Baseline (the
divisibility-driven floor): every parameter shards its tensor-parallel
axis on ``model`` and its embed axis on ``data`` (FSDP) *iff* the
dimension divides by the mesh axis's size; otherwise that axis is
replicated.  Activations shard batch on ``(pod, data)``; decode caches
shard batch on ``(pod, data)`` and heads / d_inner on ``model``; at batch 1
(long_500k) caches shard the sequence slot axis on ``data``.

A spec is computed from the mesh's axis sizes alone (a ``DeviceMesh`` or a
dict of sizes), so the rules run at production sizes with no process
group: a tuple with one entry per tensor dim, each a mesh-axis name, a
tuple of names (one dim split over several mesh axes, the first the
outer split, as in a ``PartitionSpec``) or None.  :func:`placements` turns
a spec into a DTensor placement per mesh dim, :func:`distribute_tree` a
tree of tensors into DTensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import torch

# Logical axis -> preferred mesh axis (None = replicate).
BASE_RULES: dict[str, Optional[str]] = {
    "vocab": "model",
    "embed": "data",            # FSDP weight shard
    "embed2": None,
    "ff": "model",
    "expert_ff": "model",
    "experts": "model",
    "heads": "model",
    "kv_heads": "model",
    "heads_flat": "model",
    "head_dim": None,
    "head_dim2": None,
    "modality": None,
    "layers": None,             # the stacked-layer axis, never sharded
    "q_rank": None,
    "kv_rank": None,
    "kv_rank_rope": None,
    "rope_dim": None,
    "d_inner": "model",
    "d_inner2": "model",
    "dt_state": None,
    "dt_rank": None,
    "state": None,
    "conv": None,
    "gates": None,
    # activations / caches
    "batch": ("pod", "data"),
    "seq": None,
    "cache": None,
}


@dataclass(frozen=True)
class RuleSet:
    """Sharding policy knobs (baseline + overrides)."""

    rules: dict = field(default_factory=lambda: dict(BASE_RULES))
    # decode/batch==1: shard cache sequence axis on data
    shard_cache_seq_when_b1: bool = True
    # activations: shard sequence on data when batch < data-axis size
    shard_seq_when_small_batch: bool = True
    # when a decode cache cannot shard its head axis on `model` (kv_heads %
    # model != 0, or MLA's head-less latent cache), shard the cache
    # *sequence* axis on `model` instead of replicating it.  False is the
    # divisibility-only baseline (the dry run's --baseline).
    seq_shard_cache_fallback: bool = True

    def with_overrides(self, **over) -> "RuleSet":
        r = dict(self.rules)
        r.update(over)
        return replace(self, rules=r)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or such a dict itself)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes.get(a, 1) for a in axis)
    return sizes.get(axis, 1)


def _entry(axes: tuple):
    """A spec entry as a ``PartitionSpec`` holds it: one axis by its name,
    several as a tuple, none as None."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def spec_for(axes: tuple, shape: tuple, mesh, ruleset: RuleSet) -> tuple:
    """The spec of one leaf, checking divisibility per axis: a mesh axis
    absent from the mesh is dropped (``pod`` on one pod), a mesh axis is
    used once, and a dim that its mesh axes do not divide is replicated."""
    sizes = mesh_sizes(mesh)
    out: list = []
    used: set = set()
    for dim, name in zip(shape, axes):
        axis = ruleset.rules.get(name)
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if a in sizes) or None
        elif axis not in sizes:
            axis = None
        flat = axis if isinstance(axis, tuple) else (axis,)
        if (axis is None or any(a in used for a in flat)
                or dim % _axis_size(sizes, axis) != 0):
            out.append(None)
            continue
        used.update(flat)
        out.append(_entry(flat))
    return tuple(out)


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(x, (str, type(None)))
                                        for x in v)


def tree_specs(tree_axes, tree_shapes, mesh,
               ruleset: Optional[RuleSet] = None):
    """(axes tree, tree of tensors or ``ShapeDtype``s) -> tree of specs."""
    ruleset = ruleset or RuleSet()
    if _is_axes(tree_axes):
        return spec_for(tree_axes, tuple(tree_shapes.shape), mesh, ruleset)
    return {k: tree_specs(tree_axes[k], tree_shapes[k], mesh, ruleset)
            for k in tree_axes}


# --------------------------------------------------------------------------- #
# Activation shardings                                                        #
# --------------------------------------------------------------------------- #


def batch_spec(mesh, global_batch: int, seq_len: int,
               ruleset: Optional[RuleSet] = None) -> tuple:
    """The spec of [B, T] token arrays (and [B, T, ...] activations): batch
    on the data-parallel axes, else the sequence where the batch is too
    small, else the longest prefix of those axes that divides the batch."""
    ruleset = ruleset or RuleSet()
    sizes = mesh_sizes(mesh)
    rule = ruleset.rules.get("batch", ("pod", "data"))
    if rule is None:
        rule = ()
    elif isinstance(rule, str):
        rule = (rule,)
    dp_axes = tuple(a for a in rule if a in sizes)
    dp = _axis_size(sizes, dp_axes)
    if global_batch % dp == 0:
        return (_entry(dp_axes), None)
    if ruleset.shard_seq_when_small_batch and seq_len % dp == 0:
        return (None, _entry(dp_axes))
    for k in range(len(dp_axes), 0, -1):
        sub = dp_axes[:k]
        if global_batch % _axis_size(sizes, sub) == 0:
            return (_entry(sub), None)
    return (None, None)


def cache_batch_rules(mesh, global_batch: int,
                      ruleset: Optional[RuleSet] = None,
                      prefer_seq_shard: bool = False) -> RuleSet:
    """Decode-cache ruleset: when batch cannot use the data axis (B=1 long
    context), shard the cache slot axis on data instead.  With
    ``prefer_seq_shard`` (the caller found that the head axis cannot shard)
    and ``seq_shard_cache_fallback``, shard the cache slot axis on
    ``model``."""
    ruleset = ruleset or RuleSet()
    sizes = mesh_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if global_batch % _axis_size(sizes, dp_axes) == 0:
        out = ruleset.with_overrides(batch=dp_axes)
        if (prefer_seq_shard and ruleset.seq_shard_cache_fallback
                and ruleset.rules.get("cache") is None
                and "model" in sizes):
            out = out.with_overrides(cache="model")
        return out
    if ruleset.shard_cache_seq_when_b1:
        return ruleset.with_overrides(batch=None, cache="data")
    return ruleset.with_overrides(batch=None, cache=None)


# --------------------------------------------------------------------------- #
# Placements on a DeviceMesh                                                  #
# --------------------------------------------------------------------------- #


def placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim: ``Shard(d)`` where the spec's dim ``d``
    names that mesh axis, else ``Replicate()``.  A tuple entry shards its
    dim over each of its axes in turn, the first the outer split, which
    DTensor's ``Shard`` on several mesh dims gives when they come in the
    mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits a dim in another "
                             f"order than the mesh's {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute(t: torch.Tensor, spec: tuple, mesh):
    """``t`` (the global tensor, on every rank) as a DTensor under
    ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh))


def distribute_tree(tree, tree_axes, mesh,
                    ruleset: Optional[RuleSet] = None):
    """A tree of tensors (``meta`` for an abstract one) as DTensors placed
    by the rules; ``requires_grad`` carries over."""
    ruleset = ruleset or RuleSet()
    if _is_axes(tree_axes):
        out = distribute(tree.detach(), spec_for(tree_axes, tuple(tree.shape),
                                                 mesh, ruleset), mesh)
        return out.requires_grad_(tree.requires_grad)
    return {k: distribute_tree(tree[k], tree_axes[k], mesh, ruleset)
            for k in tree_axes}


def local_bytes(shape: tuple, itemsize: int, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of a leaf under ``spec`` (each dim
    divides by its mesh axes: the rules shard no other)."""
    sizes = mesh_sizes(mesh)
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n *= dim // _axis_size(sizes, entry)
    return n * itemsize
