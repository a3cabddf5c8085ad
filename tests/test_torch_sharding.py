"""The port's sharding rules against the JAX package's.

Every logical-axes tree equals JAX's, and the spec of every param,
optimizer, cache and batch leaf equals the one JAX's ``spec_for``,
``batch_spec`` and ``cache_batch_rules`` give for the production meshes
(16x16 and 2x16x16) under the default and the ``--baseline`` rule set.
The JAX functions read only a mesh's ``axis_names`` and ``devices.shape``,
so a stub stands for the 256 or 512 devices.  Then the same specs placed
on DTensors over a ``fake`` process group: each device's argument bytes
equal those JAX's specs give, and local shard shapes match the specs.
Comparisons are exact.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jax_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import model as JM
from repro.models import sharding as JS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.data.pipeline import input_specs, text_len
from repro_torch.launch import build
from repro_torch.launch.mesh import _mesh, production_shape
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.training.optimizer import tree_leaves

MESHES = (False, True)                  # 16x16, 2x16x16


def _stub(multi_pod):
    shape, names = production_shape(multi_pod)
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _sizes(stub):
    """The stub as the port's rules take a mesh: {axis name: size}."""
    return dict(zip(stub.axis_names, stub.devices.shape))


def _rulesets(baseline):
    return (JS.RuleSet(seq_shard_cache_fallback=not baseline),
            S.RuleSet(seq_shard_cache_fallback=not baseline))


def _jspec(p, ndim):
    """A PartitionSpec as the port writes it: one entry per dim."""
    return tuple(p) + (None,) * (ndim - len(tuple(p)))


def _items(axes, tree, path=""):
    """(path, axes, leaf) of an axes tree and a tree of the same shape."""
    if isinstance(axes, dict):
        for k in axes:
            yield from _items(axes[k], tree[k], f"{path}/{k}")
    else:
        yield path, axes, tree


def _adapted(arch, shape_name, dtype="bfloat16"):
    from repro.launch.build import adapt_config as jax_adapt
    shape = SHAPES[shape_name]
    return (jax_adapt(jax_config(arch), JAX_SHAPES[shape_name], dtype),
            build.adapt_config(get_config(arch), shape, dtype))


def _cache_rules(jcfg, mesh_stub, shape, jrules, trules):
    model = dict(zip(mesh_stub.axis_names,
                     mesh_stub.devices.shape)).get("model", 1)
    prefer = jcfg.mla is not None or jcfg.n_kv_heads % model != 0
    return (JS.cache_batch_rules(mesh_stub, shape.global_batch, jrules,
                                 prefer_seq_shard=prefer),
            S.cache_batch_rules(_sizes(mesh_stub), shape.global_batch, trules,
                                prefer_seq_shard=prefer))


# --------------------------------------------------------------------------- #
# Axes trees                                                                  #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert M.params_axes(cfg) == JM.params_axes(jcfg)
    assert M.caches_axes(cfg) == JM.caches_axes(jcfg)
    params = M.abstract_params(cfg)
    for path, axes, leaf in _items(M.params_axes(cfg), params):
        assert len(axes) == leaf.ndim, path
    caches = M.abstract_caches(cfg, 2, 8, 4 if cfg.is_encoder_decoder
                               else 0)
    for path, axes, leaf in _items(M.caches_axes(cfg), caches):
        assert len(axes) == leaf.ndim, path


# --------------------------------------------------------------------------- #
# Leaf specs at production sizes                                              #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("baseline", [False, True], ids=["perf", "baseline"])
@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_specs_equal_jax(arch, multi_pod, baseline):
    stub = _stub(multi_pod)
    sizes = _sizes(stub)
    jrules, trules = _rulesets(baseline)
    n = 0
    for shape_name, shape in SHAPES.items():
        jcfg, cfg = _adapted(arch, shape_name)
        axes = M.params_axes(cfg)
        params = M.abstract_params(cfg)
        # params; AdamW's m and v have the params' shapes and axes
        for path, ax, leaf in _items(axes, params):
            want = JS.spec_for(ax, tuple(leaf.shape), stub, jrules)
            assert S.spec_for(ax, tuple(leaf.shape), sizes, trules) == \
                _jspec(want, leaf.ndim), (shape_name, path)
            n += 1
        got_b = S.batch_spec(sizes, shape.global_batch,
                             text_len(cfg, shape), trules)
        want_b = JS.batch_spec(stub, shape.global_batch,
                               text_len(cfg, shape), jrules)
        assert got_b == _jspec(want_b, 2)
        if shape.kind != "decode":
            continue
        tok = S.batch_spec(sizes, shape.global_batch, 1, trules)
        assert tok == _jspec(JS.batch_spec(stub, shape.global_batch, 1,
                                           jrules), 2)
        jc, tc = _cache_rules(jcfg, stub, shape, jrules, trules)
        caches = M.abstract_caches(cfg, shape.global_batch,
                                   build.decode_cache_len(cfg, shape),
                                   shape.seq_len if cfg.is_encoder_decoder
                                   else 0)
        for path, ax, leaf in _items(M.caches_axes(cfg), caches):
            want = JS.spec_for(ax, tuple(leaf.shape), stub, jc)
            assert S.spec_for(ax, tuple(leaf.shape), sizes, tc) == \
                _jspec(want, leaf.ndim), (shape_name, path)
            n += 1
    assert n > 0


@pytest.mark.parametrize("baseline", [False, True], ids=["perf", "baseline"])
def test_cache_batch_rules_equal_jax(baseline):
    """Both branches of the cache rules (batch divides the data axes or
    not) and the sequence-shard fallback, rule for rule."""
    for multi_pod in MESHES:
        stub = _stub(multi_pod)
        jrules, trules = _rulesets(baseline)
        for batch in (1, 3, 32, 128):
            for prefer in (False, True):
                j = JS.cache_batch_rules(stub, batch, jrules, prefer)
                t = S.cache_batch_rules(_sizes(stub), batch, trules, prefer)
                assert t.rules == j.rules


# --------------------------------------------------------------------------- #
# DTensors over a fake process group                                          #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def fake_group():
    """``group(world)``: the default process group as the ``fake`` backend
    at that world size, re-made when the size changes; destroyed at the
    end of the module."""
    def group(world):
        if dist.is_initialized() and dist.get_world_size() == world:
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)

    yield group
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_at(tree, path):
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree


def _jax_local_bytes(spec, shape, itemsize, sizes):
    n = 1
    for dim, entry in zip(shape, _jspec(spec, len(shape))):
        axes = entry if isinstance(entry, tuple) else (entry,)
        n *= dim // math.prod(sizes.get(a, 1) for a in axes if a)
    return n * itemsize


def _jax_argument_bytes(arch, shape_name, stub):
    """Per-device bytes of a step's arguments from JAX's specs (the
    shapes and dtypes of the port's abstract trees, which
    tests/test_torch_launch.py holds against JAX's)."""
    jcfg, cfg = _adapted(arch, shape_name)
    shape = SHAPES[shape_name]
    jrules = JS.RuleSet()
    sizes = dict(zip(stub.axis_names, stub.devices.shape))
    total = 0
    params = M.abstract_params(cfg)
    leaves = list(_items(M.params_axes(cfg), params))
    for _, ax, leaf in leaves:
        total += _jax_local_bytes(JS.spec_for(ax, tuple(leaf.shape), stub,
                                              jrules), leaf.shape,
                                  leaf.element_size(), sizes)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        for _, ax, leaf in leaves:                 # m and v, f32
            total += 2 * _jax_local_bytes(JS.spec_for(
                ax, tuple(leaf.shape), stub, jrules), leaf.shape, 4, sizes)
        total += 4                                 # the step counter
    if shape.kind != "decode":
        bspec = JS.batch_spec(stub, shape.global_batch, text_len(cfg, shape),
                              jrules)
        for sd in specs.values():
            nd = len(sd.shape)
            spec = (tuple(bspec) + (None,) * nd)[:nd]
            total += _jax_local_bytes(spec, sd.shape,
                                      torch.empty((), dtype=sd.dtype)
                                      .element_size(), sizes)
    if shape.kind == "train":
        return total
    jc, _ = _cache_rules(jcfg, stub, shape, jrules, S.RuleSet())
    caches = M.abstract_caches(cfg, shape.global_batch,
                               build.decode_cache_len(cfg, shape),
                               shape.seq_len if cfg.is_encoder_decoder
                               else 0)
    for _, ax, leaf in _items(M.caches_axes(cfg), caches):
        total += _jax_local_bytes(JS.spec_for(ax, tuple(leaf.shape), stub,
                                              jc), leaf.shape,
                                  leaf.element_size(), sizes)
    if shape.kind == "decode":
        tok = JS.batch_spec(stub, shape.global_batch, 1, jrules)
        total += _jax_local_bytes(tok, (shape.global_batch, 1), 4, sizes)
    return total


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_jax_specs(fake_group, arch, multi_pod):
    """Each device's bytes of the dry run's step arguments (DTensors of
    meta shards placed by the port's rules) equal what JAX's specs give."""
    shape, names = production_shape(multi_pod)
    fake_group(math.prod(shape))
    mesh = _mesh(shape, names, "cpu")
    stub = _stub(multi_pod)
    for shape_name in SHAPES:
        _, cfg = _adapted(arch, shape_name)
        with torch.inference_mode(SHAPES[shape_name].kind != "train"):
            args = build.step_args(cfg, SHAPES[shape_name], mesh)
        assert build._local_bytes(args) == \
            _jax_argument_bytes(arch, shape_name, stub), shape_name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_shapes_match_specs(fake_group, arch):
    """On an 8-rank (2, 4) mesh, every smoke-size param's local shard has
    the shape its spec gives."""
    fake_group(8)
    mesh = _mesh((2, 4), ("data", "model"), "cpu")
    cfg = get_smoke_config(arch)
    axes = M.params_axes(cfg)
    params = S.distribute_tree(M.abstract_params(cfg), axes, mesh)
    specs = S.tree_specs(axes, params, mesh)
    sizes = S.mesh_sizes(mesh)
    n_sharded = 0
    for path, _, leaf in _items(axes, params):
        spec = _spec_at(specs, path)
        want = tuple(d // math.prod(sizes[a] for a in (
            e if isinstance(e, tuple) else (e,))) if e else d
            for d, e in zip(leaf.shape, spec))
        assert tuple(leaf.to_local().shape) == want, path
        assert leaf.to_local().device.type == "meta"
        n_sharded += any(spec)
    assert n_sharded > 0
    assert len(list(tree_leaves(params))) == len(list(_items(axes, params)))


def test_placements_follow_the_spec(fake_group):
    from torch.distributed.tensor import Replicate, Shard
    fake_group(8)
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert S.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert S.placements((None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        S.placements((("data", "pod"),), mesh)
    # ("pod", "data") on one dim: pod the outer split, as a PartitionSpec
    t = torch.arange(8.0)
    dt = S.distribute(t, (("pod", "data"),), mesh)
    assert torch.equal(dt.to_local(), t[:2])          # rank 0: pod 0, data 0
