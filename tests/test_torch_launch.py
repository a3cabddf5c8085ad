"""The port's launch tools against the JAX package's, and the DTensor path
of its steps.

- ``input_specs``, ``abstract_params`` and ``abstract_caches`` give JAX's
  ``eval_shape`` shapes and dtypes for every architecture at the four
  input shapes (exact).
- The wire formulas of ``cost_analysis`` equal JAX's ``collective_bytes``
  on HLO lines of the same kind, result size and group; the analytic
  model FLOPs equal JAX's (exact).
- The kernels' meta branches launch nothing and report their work;
  ``check_build_combo`` (run by tests/test_torch_dryrun*.py) runs every
  architecture's train, prefill, decode and long-context decode step at
  smoke size on fake (2, 4) and (2, 2, 2) meshes.
- On a one-rank ``gloo`` mesh the steps on DTensors give the plain
  tensors' logits, tokens, loss (1e-6) and gradients (1e-5: the DTensor
  path's cross-entropy takes its log-sum-exp as max, exp, sum and log,
  which rounds the logits' gradient otherwise).
- ``moe_group_size`` reaches the port's prefill and serve steps: their
  logits and tokens match JAX's at a group of 4 (2e-4, the reference's
  tolerance).
"""
import functools
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.data import pipeline as JP
from repro.launch import hlo_analysis as JHA
from repro.launch.build import adapt_config as jax_adapt
from repro.launch.build import decode_cache_len as jax_cache_len
from repro.models import model as JM
from repro.training import steps as JS
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.data.pipeline import input_specs
from repro_torch.kernels import _shard
from repro_torch.launch import build, cost_analysis as CA
from repro_torch.launch.mesh import _mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.convert import params_from_numpy
from repro_torch.training import steps
from repro_torch.training.optimizer import tree_leaves

TOL = 2e-4


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _sd(leaf):
    """(shape, dtype name) of a JAX or torch leaf or stand-in."""
    dt = leaf.dtype
    name = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name
    return tuple(leaf.shape), name


@functools.lru_cache(maxsize=None)
def _jax_abstract_params(arch, long_context):
    shape = JAX_SHAPES["long_500k" if long_context else "train_4k"]
    return dict(_flat(JM.abstract_params(jax_adapt(jax_config(arch), shape))))


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_and_input_specs_match_jax(arch, shape_name):
    shape = SHAPES[shape_name]
    jcfg = jax_adapt(jax_config(arch), JAX_SHAPES[shape_name])
    cfg = build.adapt_config(get_config(arch), shape)
    got = {k: _sd(v) for k, v in _flat(M.abstract_params(cfg))}
    want = {k: _sd(v) for k, v in _jax_abstract_params(
        arch, shape_name == "long_500k").items()}
    assert got == want
    assert all(v.device.type == "meta"
               for v in tree_leaves(M.abstract_params(cfg)))
    assert {k: _sd(v) for k, v in input_specs(cfg, shape).items()} == \
        {k: _sd(v) for k, v in JP.input_specs(jcfg, JAX_SHAPES[shape_name])
         .items()}
    if shape.kind != "decode":
        return
    cache_len = build.decode_cache_len(cfg, shape)
    assert cache_len == jax_cache_len(jcfg, JAX_SHAPES[shape_name])
    enc = shape.seq_len if cfg.is_encoder_decoder else 0
    got = {k: _sd(v) for k, v in _flat(M.abstract_caches(
        cfg, shape.global_batch, cache_len, enc))}
    want = {k: _sd(v) for k, v in _flat(JM.abstract_caches(
        jcfg, shape.global_batch, cache_len, enc))}
    assert got == want


@pytest.mark.parametrize("kind", CA.COLLECTIVES)
def test_wire_bytes_equal_jax_collective_bytes(kind):
    for n_elems, group in [(1024, 16), (4096 * 896, 256), (7, 2),
                           (65536, 512)]:
        line = (f"  %c.1 = f32[{n_elems}]{{0}} {kind}(f32[{n_elems}]{{0}} "
                f"%p.1), replica_groups=[{512 // group},{group}]<=[512], "
                "dimensions={0}")
        want = JHA.collective_bytes(line)
        assert want.count == 1
        assert CA.wire_bytes(kind, 4 * n_elems, group) == \
            want.by_kind[kind]
        stats = CA.collective_stats([(kind, 4 * n_elems, group)] * 3)
        assert stats.count == 3
        assert stats.total_bytes == 3 * want.total_bytes


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_model_flops_equal_jax(arch):
    for name, shape in SHAPES.items():
        cfg = build.adapt_config(get_config(arch), shape)
        jcfg = jax_adapt(jax_config(arch), JAX_SHAPES[name])
        assert CA.analytic_model_flops(cfg, shape) == \
            JHA.analytic_model_flops(jcfg, JAX_SHAPES[name])


def test_roofline_terms_use_the_h100_constants():
    r = CA.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=100e9,
                    chips=4, dtype="bfloat16", model_flops=4 * 989e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 2.0)
    assert r.bottleneck == "collective" and r.useful_flops_ratio == 1.0
    assert CA.Roofline(67e12, 0, 0, 1, "float32").compute_s == 1.0


# --------------------------------------------------------------------------- #
# build_combo on fake meshes                                                  #
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def group():
    """``group(backend, world)``: the default process group, re-made when
    the backend or world size changes; destroyed at the end."""
    state = {}

    def make(backend, world):
        if state.get("key") == (backend, world):
            return
        if dist.is_initialized():
            dist.destroy_process_group()
        if backend == "fake":
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
        else:
            store = dist.HashStore()
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=world)
        state["key"] = (backend, world)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


SMOKE_SHAPES = {
    "train": InputShape("train_s", 32, 8, "train"),
    "prefill": InputShape("prefill_s", 32, 4, "prefill"),
    "decode": InputShape("decode_s", 32, 8, "decode"),
    "long": InputShape("long_500k", 64, 1, "decode"),
}
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


def check_build_combo(make_group, arch, mesh_name):
    """``build_combo`` of ``arch`` at every step kind (smoke size) on a fake
    mesh: bytes, FLOPs and collectives counted, and the kernels of the
    model's layers through their meta branches.  The dry-run test files
    (tests/test_torch_dryrun*.py) run it, split by architecture so that
    their workers share the time."""
    shape, names = MESHES[mesh_name]
    make_group("fake", math.prod(shape))
    mesh = _mesh(shape, names, "cpu")
    mixers = {ld.mixer for ld in get_smoke_config(arch).layer_defs()}
    for kind, ishape in SMOKE_SHAPES.items():
        cfg = build.adapt_config(get_smoke_config(arch), ishape, "float32")
        combo = build.build_combo(arch, ishape, mesh, cfg_override=cfg)
        assert combo.kind == ishape.kind and combo.chips == 8
        assert combo.argument_bytes > 0 and combo.output_bytes > 0
        assert combo.peak_bytes >= combo.argument_bytes
        roof = combo.roofline
        assert roof.flops > 0 and roof.hbm_bytes > 0
        assert roof.n_collectives > 0 and roof.coll_bytes > 0
        assert set(roof.collectives) <= set(CA.COLLECTIVES)
        # the kernels of the model's layers ran their meta branch
        ran = set(combo.kernels)
        if "attn" in mixers:
            assert ("decode_attention" if ishape.kind == "decode"
                    else "flash_attention") in ran, kind
        if "slstm" in mixers:
            assert "slstm_scan" in ran, kind
        if kind == "train" and mixers & {"attn", "mla"}:
            assert "flash_attention_bwd" in ran
        if kind == "train" and "slstm" in mixers:
            assert "slstm_scan_bwd" in ran


def test_meta_kernels_report_their_work():
    """A wrapper on meta tensors launches nothing and counts no launch; it
    reports the operations and bytes ``chip_smoke.py`` bounds it by."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.slstm_scan import slstm_scan
    seen = []
    m = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
        s, dtype=dt, device="meta")
    with _shard.recording(lambda *a: seen.append(a)):
        out = flash_attention(m(2, 5, 4, 8), m(2, 5, 2, 8), m(2, 5, 2, 8),
                              m(5, dt=torch.int32), m(5, dt=torch.int32))
        assert out.shape == (2, 5, 4, 8) and out.device.type == "meta"
        out = decode_attention(m(2, 4, 8), m(2, 16, 2, 8), m(2, 16, 2, 8),
                               m(2, 16, dt=torch.int32), 9)
        assert out.shape == (2, 4, 8)
        hs, final = slstm_scan(m(2, 3, 4, 2, 8), m(4, 2, 8, 8), m(4, 2, 8))
        assert hs.shape == (2, 3, 2, 8) and len(final) == 4
    assert decode_attention.launches == flash_attention.launches == 0
    assert slstm_scan.launches == 0
    names = [s[0] for s in seen]
    assert names == ["flash_attention", "decode_attention", "slstm_scan"]
    # flash: 4 H D per (query, key) pair, 2 x 15 causal pairs
    assert seen[0][1] == 4.0 * 4 * 8 * 2 * 15
    # decode: 10 valid slots of 16 in each of 2 rows
    assert seen[1][1] == 4.0 * 4 * 8 * 2 * 10


# --------------------------------------------------------------------------- #
# The DTensor path on a real one-rank mesh                                    #
# --------------------------------------------------------------------------- #


DTENSOR_ARCHS = ["qwen2-0.5b", "xlstm-1.3b", "deepseek-v2-236b",
                 "jamba-1.5-large-398b"]


def _dist_params(params, cfg, mesh):
    return S.distribute_tree(params, M.params_axes(cfg), mesh)


@pytest.mark.parametrize("arch", DTENSOR_ARCHS)
def test_dtensor_steps_match_plain_on_one_rank(group, arch):
    from torch.distributed.tensor.experimental import implicit_replication
    group("gloo", 1)
    mesh = _mesh((1, 1), ("data", "model"), "cpu")
    cfg = replace(get_smoke_config(arch), param_dtype="float32",
                  activation_dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9))).long()
    prompt = {"tokens": toks[:, :8]}
    pre = steps.make_prefill_step(cfg, 16, device="cpu")
    srv = steps.make_serve_step(cfg, device="cpu")
    with implicit_replication():
        dlogits, _ = M.forward(_dist_params(params, cfg, mesh), cfg,
                               {"tokens": toks})
        # the serving steps run under inference mode: their DTensor
        # arguments are made there
        with torch.inference_mode():
            dparams = _dist_params(params, cfg, mesh)
            dcaches = S.distribute_tree(
                M.init_caches(cfg, 2, 16, device="cpu"), M.caches_axes(cfg),
                mesh)
            dprompt = {"tokens": S.distribute(prompt["tokens"], ("data",),
                                              mesh)}
        dtok, dcaches = pre(dparams, dprompt, dcaches)
        with torch.inference_mode():
            dtok1 = S.distribute(dtok.full_tensor()[:, None], ("data",),
                                 mesh)
        dnext, _ = srv(dparams, dcaches, dtok1, 8)
    logits, _ = M.forward(params, cfg, {"tokens": toks})
    tok, caches = pre(params, prompt)
    nxt, _ = srv(params, caches, tok[:, None], 8)
    torch.testing.assert_close(dlogits.full_tensor(), logits, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(dtok.full_tensor(), tok)
    assert torch.equal(dnext.full_tensor(), nxt)
    # a train step's loss and every gradient
    batch = {"tokens": toks[:, :8], "labels": toks[:, 1:]}
    loss, _, grads = steps.loss_and_grads(params, cfg, batch)
    dbatch = {k: S.distribute(v, ("data",), mesh) for k, v in batch.items()}
    with implicit_replication():
        dloss, _, dgrads = steps.loss_and_grads(
            _dist_params(params, cfg, mesh), cfg, dbatch)
    torch.testing.assert_close(dloss.full_tensor(), loss, rtol=1e-6,
                               atol=1e-6)
    for (path, g), (_, dg) in zip(_flat(grads), _flat(dgrads)):
        torch.testing.assert_close(dg.full_tensor(), g, rtol=1e-5,
                                   atol=1e-5, msg=path)


# --------------------------------------------------------------------------- #
# moe_group_size through the serving steps                                    #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "jamba-1.5-large-398b"])
def test_serving_steps_take_moe_group_size(arch):
    group_size = 4
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jtok, jc = JS.make_prefill_step(jcfg, 32, moe_group_size=group_size)(
        jp, {"tokens": jnp.asarray(toks)})
    jnext, _ = JS.make_serve_step(jcfg, moe_group_size=group_size)(
        jp, jc, jtok[:, None], jnp.int32(12))
    jlog, jc2 = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32,
                           moe_group_size=group_size)
    jdec, _ = JM.decode_step(jp, jcfg, jc2, jtok[:, None], jnp.int32(12),
                             moe_group_size=group_size)
    pre = steps.make_prefill_step(tcfg, 32, moe_group_size=group_size,
                                  device="cpu")
    srv = steps.make_serve_step(tcfg, moe_group_size=group_size,
                                device="cpu")
    tt = torch.from_numpy(toks).long()
    ttok, tc = pre(tp, {"tokens": tt})
    tnext, _ = srv(tp, tc, ttok[:, None], 12)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    assert np.array_equal(tnext.numpy(), np.asarray(jnext))
    with torch.inference_mode():
        tlog, tc2 = M.prefill(tp, tcfg, {"tokens": tt}, 32,
                              moe_group_size=group_size)
        tdec, _ = M.decode_step(tp, tcfg, tc2, ttok[:, None].long(), 12,
                                moe_group_size=group_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), rtol=TOL,
                               atol=TOL)
    # the group size is honoured: at 256 the capacity drops differ
    tlog256, _ = M.prefill(tp, tcfg, {"tokens": tt}, 32)
    assert not torch.equal(tlog256, tlog)
