"""The port's checkpoint store and lifecycle snapshots
(``repro_torch/checkpoint``): twins of the JAX store's durability and
dtype-safety cases (tests/test_checkpoint_store.py), with numpy and with
torch leaves; twins of the lifecycle cases (tests/test_churn.py); the
on-disk format shared with the JAX store (identical manifests and arrays,
checkpoints of a train state crossing both ways, the port's next step
matching JAX's); and the bfloat16 leaf that neither store restores.

Tolerances of the resumed step: those of tests/test_torch_train.py
(loss 1e-5, params 1e-5 where the gradient is not near zero)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import InputShape as JInputShape
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import steps as JS
from repro_torch.checkpoint import lifecycle as ck_lifecycle
from repro_torch.checkpoint import store
from repro_torch.configs import get_smoke_config
from repro_torch.core.calendar import DeviceLifecycle, NetworkState
from repro_torch.core.task import LowPriorityRequest
from repro_torch.models.convert import opt_state_from_numpy, \
    params_from_numpy
from repro_torch.training import optimizer as TO
from repro_torch.training import steps as TS

KINDS = ["numpy", "torch"]


def tree(kind="numpy"):
    t = {
        "w": np.arange(6, dtype=np.float32).reshape(2, 3),
        "step": np.asarray(7, dtype=np.int64),
        "mask": np.asarray([True, False, True]),
    }
    return t if kind == "numpy" else {k: torch.from_numpy(v.copy())
                                      for k, v in t.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("kind", KINDS)
def test_roundtrip(tmp_path, kind):
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind), {"note": "x"})
    assert store.exists(path)
    out = store.restore(path, tree(kind))
    assert type(out["w"]) is type(tree(kind)["w"])
    assert _np(out["w"]).dtype == np.float32
    np.testing.assert_array_equal(_np(out["w"]), tree()["w"])
    np.testing.assert_array_equal(_np(out["mask"]), tree()["mask"])
    assert store.load_metadata(path) == {"note": "x"}


@pytest.mark.parametrize("kind", KINDS)
def test_restore_refuses_dtype_mismatch_naming_leaf(tmp_path, kind):
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind))
    ref = tree(kind)
    ref["step"] = np.asarray(0.0, dtype=np.float64) if kind == "numpy" \
        else torch.tensor(0.0, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"\['step'\].*int64.*float64"):
        store.restore(path, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_restore_cast_opt_in(tmp_path, kind):
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind))
    ref = tree(kind)
    ref["step"] = np.asarray(0.0, dtype=np.float64) if kind == "numpy" \
        else torch.tensor(0.0, dtype=torch.float64)
    out = store.restore(path, ref, cast=True)
    assert _np(out["step"]).dtype == np.float64 and out["step"] == 7.0


@pytest.mark.parametrize("kind", KINDS)
def test_restore_still_validates_shape(tmp_path, kind):
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind))
    ref = tree(kind)
    ref["w"] = np.zeros((3, 2), dtype=np.float32) if kind == "numpy" \
        else torch.zeros((3, 2))
    with pytest.raises(ValueError, match=r"\['w'\].*shape"):
        store.restore(path, ref)
    with pytest.raises(ValueError, match=r"\['w'\].*shape"):
        store.restore(path, ref, cast=True)


@pytest.mark.parametrize("kind", KINDS)
def test_save_overwrites_atomically(tmp_path, kind):
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind), {"v": 1})
    t2 = tree(kind)
    t2["w"] = t2["w"] + 1.0
    store.save(path, t2, {"v": 2})
    out = store.restore(path, tree(kind))
    np.testing.assert_array_equal(_np(out["w"]), tree()["w"] + 1.0)
    assert store.load_metadata(path) == {"v": 2}
    # no temp/backup litter left behind
    assert [p for p in os.listdir(tmp_path) if p != "ckpt"] == []


@pytest.mark.parametrize("kind", KINDS)
def test_failed_swap_rolls_previous_checkpoint_back(tmp_path, monkeypatch,
                                                    kind):
    """If the final temp-dir -> path rename fails, the previous checkpoint
    is rolled back into place (path never stays empty on a survivable
    error)."""
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind), {"v": 1})
    real_replace = os.replace

    def flaky_replace(src, dst):
        if src.startswith(f"{path}.tmp."):
            raise OSError("no rename for you")
        return real_replace(src, dst)

    monkeypatch.setattr(store.os, "replace", flaky_replace)
    with pytest.raises(OSError, match="no rename"):
        store.save(path, tree(kind), {"v": 2})
    monkeypatch.undo()
    assert store.exists(path)
    assert store.load_metadata(path) == {"v": 1}
    store.restore(path, tree(kind))
    # the next successful save clears any leftover litter
    store.save(path, tree(kind), {"v": 3})
    assert store.load_metadata(path) == {"v": 3}
    assert [p for p in os.listdir(tmp_path) if p != "ckpt"] == []


@pytest.mark.parametrize("kind", KINDS)
def test_interrupted_save_leaves_previous_checkpoint_intact(tmp_path,
                                                            monkeypatch,
                                                            kind):
    path = str(tmp_path / "ckpt")
    store.save(path, tree(kind), {"v": 1})

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(store.np, "savez", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        store.save(path, tree(kind), {"v": 2})
    monkeypatch.undo()
    # the previous checkpoint is fully readable; nothing torn, no litter
    assert store.exists(path)
    out = store.restore(path, tree(kind))
    np.testing.assert_array_equal(_np(out["w"]), tree()["w"])
    assert store.load_metadata(path) == {"v": 1}
    assert [p for p in os.listdir(tmp_path) if p != "ckpt"] == []


def test_restore_missing_leaf_and_device(tmp_path):
    path = str(tmp_path / "ckpt")
    store.save(path, tree("torch"))
    ref = dict(tree("torch"), extra=torch.zeros(2))
    with pytest.raises(KeyError, match=r"\['extra'\]"):
        store.restore(path, ref)
    out = store.restore(path, tree("torch"))
    assert all(v.device.type == "cpu" for v in out.values())
    assert out["w"].data_ptr() != tree("torch")["w"].data_ptr()


# --------------------------------------------------------------------------- #
# Lifecycle checkpointing (twins of tests/test_churn.py)                      #
# --------------------------------------------------------------------------- #


def lp_request(dev=0, deadline=30.0, n=1, frame=0):
    req = LowPriorityRequest(source_device=dev, deadline=deadline,
                             frame_id=frame, n_tasks=n)
    req.make_tasks()
    return req


def test_lifecycle_checkpoint_roundtrip_mid_drain(tmp_path):
    st = NetworkState(4)
    st.drain_device(1)
    req = lp_request(dev=2, n=2)
    st.devices[2].reserve(0.0, 9.0, 2, req.tasks[0])
    orphans = [t.task_id for t in st.fail_device(2, now=1.0)]
    path = str(tmp_path / "ckpt")
    ck_lifecycle.save_lifecycle(path, st, pending_orphans=orphans,
                                metadata={"virtual_now": 1.0})
    meta = store.load_metadata(path)
    assert meta["kind"] == "device_lifecycle"
    assert meta["n_devices"] == 4 and meta["n_orphans"] == len(orphans)

    # restore into a fresh fleet that has picked up unrelated state
    st2 = NetworkState(4)
    st2.devices[2].reserve(0.0, 5.0, 4, lp_request(dev=2, frame=9).tasks[0])
    pending = ck_lifecycle.restore_lifecycle(path, st2)
    assert pending == sorted(orphans)
    assert st2.devices[1].lifecycle is DeviceLifecycle.DRAINING
    assert st2.devices[2].lifecycle is DeviceLifecycle.DOWN
    assert not list(st2.devices[2].reservations())
    plane = st2.probe_plane()
    assert plane.alive.tolist() == [True, False, False, True]


def test_lifecycle_restore_validates_fleet_size_and_kind(tmp_path):
    st = NetworkState(3)
    path = str(tmp_path / "ckpt")
    ck_lifecycle.save_lifecycle(path, st)
    with pytest.raises(ValueError, match="3 devices"):
        ck_lifecycle.restore_lifecycle(path, NetworkState(5))
    other = str(tmp_path / "other")
    store.save(other, {"x": np.zeros(3)}, metadata={"kind": "weights"})
    with pytest.raises(ValueError, match="not a device-lifecycle"):
        ck_lifecycle.restore_lifecycle(other, st)


def test_lifecycle_restore_rejects_tampered_payloads(tmp_path):
    st = NetworkState(3)
    st.fail_device(0, now=0.0)
    tree_ = ck_lifecycle.lifecycle_tree(st)
    meta = {"kind": "device_lifecycle", "n_devices": 3, "n_orphans": 0}
    bad = dict(tree_, alive_mask=np.array([True, True, True]))
    path = str(tmp_path / "bad")
    store.save(path, bad, metadata=meta)
    with pytest.raises(ValueError, match="disagrees"):
        ck_lifecycle.restore_lifecycle(path, NetworkState(3))
    bad2 = dict(tree_, lifecycle=np.array([7, 0, 0], dtype=np.int8),
                alive_mask=np.array([False, True, True]))
    path2 = str(tmp_path / "bad2")
    store.save(path2, bad2, metadata=meta)
    with pytest.raises(ValueError, match="unknown lifecycle codes"):
        ck_lifecycle.restore_lifecycle(path2, NetworkState(3))
    bad3 = dict(tree_, lifecycle=tree_["lifecycle"].astype(np.float32))
    path3 = str(tmp_path / "bad3")
    store.save(path3, bad3, metadata=meta)
    with pytest.raises(ValueError, match="dtype"):
        ck_lifecycle.restore_lifecycle(path3, NetworkState(3))


def test_lifecycle_enum_values_are_the_wire_encoding():
    assert DeviceLifecycle.UP.value == 0
    assert DeviceLifecycle.DRAINING.value == 1
    assert DeviceLifecycle.DOWN.value == 2


def test_lifecycle_snapshots_cross_between_the_packages(tmp_path):
    """A lifecycle snapshot of either package restores in the other."""
    from repro.checkpoint import lifecycle as jlifecycle
    from repro.core.calendar import NetworkState as JNetworkState
    st = NetworkState(4)
    st.drain_device(3)
    path = str(tmp_path / "port")
    ck_lifecycle.save_lifecycle(path, st, pending_orphans=[5, 2])
    jst = JNetworkState(4)
    assert jlifecycle.restore_lifecycle(path, jst) == [2, 5]
    assert jst.lifecycle_codes().tolist() == st.lifecycle_codes().tolist()
    jst.fail_device(0, now=0.0)
    jpath = str(tmp_path / "jax")
    jlifecycle.save_lifecycle(jpath, jst, pending_orphans=[9])
    st2 = NetworkState(4)
    assert ck_lifecycle.restore_lifecycle(jpath, st2) == [9]
    assert st2.lifecycle_codes().tolist() == jst.lifecycle_codes().tolist()


# --------------------------------------------------------------------------- #
# The on-disk format, shared with the JAX store                               #
# --------------------------------------------------------------------------- #


OPT = dict(lr=1e-3, warmup_steps=1, total_steps=8)


def _jax_state(arch, steps=1):
    cfg = jax_smoke_config(arch)
    opt = JO.AdamWConfig(**OPT)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    state = JO.init_opt_state(opt, params)
    batches = JP.train_batches(cfg, JInputShape("t", 12, 2, "train"))
    step = JS.make_train_step(cfg, opt)
    for _ in range(steps):
        params, state, _ = step(params, state, next(batches))
    return cfg, opt, params, state, batches


def test_manifests_and_arrays_identical(tmp_path):
    """The same train state saved by both stores: the same manifest text,
    the same keys (JAX key paths), dtypes, shapes and bytes."""
    _, _, params, state, _ = _jax_state("qwen2-0.5b", steps=1)
    jtree = {"params": params, "opt_state": state}
    ttree = {"params": params_from_numpy(jax.tree.map(np.asarray, params),
                                         "cpu"),
             "opt_state": opt_state_from_numpy(
                 jax.tree.map(np.asarray, state), "cpu")}
    jstore.save(str(tmp_path / "j"), jtree, {"arch": "qwen2-0.5b"})
    store.save(str(tmp_path / "t"), ttree, {"arch": "qwen2-0.5b"})
    texts = [open(tmp_path / p / "manifest.json").read() for p in "jt"]
    assert texts[0] == texts[1]
    leaves = json.loads(texts[0])["leaves"]
    assert "['params']['dec0']['p0']['mixer']['wq']" in leaves
    assert "['opt_state']['m']['embed']" in leaves
    assert leaves["['opt_state']['step']"] == {"shape": [],
                                               "dtype": "int32"}
    za, zb = (np.load(tmp_path / p / "arrays.npz") for p in "jt")
    assert sorted(za.files) == sorted(zb.files) == sorted(leaves)
    for key in za.files:
        assert za[key].dtype == zb[key].dtype
        np.testing.assert_array_equal(za[key], zb[key])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-236b"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, arch):
    """A JAX train state after one step, saved by the JAX store, restores
    into the port's tensors; the port's next step then matches JAX's."""
    jcfg, jopt, params, state, batches = _jax_state(arch, steps=1)
    path = str(tmp_path / "ckpt")
    jstore.save(path, {"params": params, "opt_state": state})
    tcfg = get_smoke_config(arch)
    tparams, tstate = TS.init_train_state(
        tcfg, 5, TO.AdamWConfig(**OPT), device="cpu")       # other values
    back = store.restore(path, {"params": tparams, "opt_state": tstate})
    tparams, tstate = back["params"], back["opt_state"]
    assert int(tstate["step"]) == 1 and tstate["step"].dtype == torch.int32
    batch = next(batches)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.grad(lambda p: JS.loss_fn(p, jcfg, jbatch)[0])(params)
    params, state, jm = JS.make_train_step(jcfg, jopt)(params, state,
                                                       jbatch)
    tparams, tstate, tm = TS.make_train_step(
        tcfg, TO.AdamWConfig(**OPT), device="cpu")(tparams, tstate, batch)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-5
    assert int(tstate["step"]) == 2
    for p, w, g in zip(TO.tree_leaves(tparams), jax.tree.leaves(params),
                       jax.tree.leaves(jgrads), strict=True):
        g = np.abs(np.asarray(g))
        keep = g > 1e-4 * g.max()
        diff = np.abs(p.detach().numpy() - np.asarray(w))
        assert diff[keep].max(initial=0.0) < 1e-5


def test_port_checkpoint_restores_in_jax(tmp_path):
    """A port train state after one step, saved by the port's store,
    restores into the JAX tree's structure with the same values."""
    cfg = get_smoke_config("jamba-1.5-large-398b")
    opt = TO.AdamWConfig(**OPT)
    params, state = TS.init_train_state(cfg, 0, opt, device="cpu")
    batch = next(JP.train_batches(jax_smoke_config(cfg.name),
                                  JInputShape("t", 12, 2, "train")))
    params, state, _ = TS.make_train_step(cfg, opt, device="cpu")(
        params, state, batch)
    path = str(tmp_path / "ckpt")
    store.save(path, {"params": params, "opt_state": state})
    jcfg = jax_smoke_config(cfg.name)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    jref = {"params": jparams,
            "opt_state": JO.init_opt_state(JO.AdamWConfig(**OPT), jparams)}
    back = jstore.restore(path, jref)
    mine = {"params": params, "opt_state": state}
    for (kpath, got), want in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            TO.tree_leaves(mine), strict=True):
        assert np.asarray(got).dtype == want.detach().numpy().dtype, kpath
        np.testing.assert_array_equal(np.asarray(got),
                                      want.detach().numpy())
    assert int(back["opt_state"]["step"]) == 1


def test_bf16_leaves_are_refused_by_both_stores(tmp_path):
    """A bfloat16 leaf is written as raw 2-byte words (numpy |V2) with
    "bfloat16" in the manifest by both stores, and neither restores it:
    the dtype check refuses |V2, and there is no cast from it."""
    x = torch.tensor([[1.0, -2.5, 3.0e-3]], dtype=torch.bfloat16)
    tpath, jpath = str(tmp_path / "t"), str(tmp_path / "j")
    store.save(tpath, {"w": x})
    jstore.save(jpath, {"w": jnp.asarray(x.float().numpy(), jnp.bfloat16)})
    for path in (tpath, jpath):
        manifest = json.load(open(os.path.join(path, "manifest.json")))
        assert manifest["leaves"]["['w']"] == {"shape": [1, 3],
                                               "dtype": "bfloat16"}
        raw = np.load(os.path.join(path, "arrays.npz"))["['w']"]
        assert raw.dtype.str == "|V2"
        np.testing.assert_array_equal(raw.view(np.int16),
                                      x.view(torch.int16).numpy())
        with pytest.raises(ValueError,
                           match=r"\['w'\].*\|V2 != expected bfloat16"):
            store.restore(path, {"w": x})
        with pytest.raises(ValueError, match="No cast function"):
            store.restore(path, {"w": x}, cast=True)
        jref = {"w": jnp.zeros((1, 3), jnp.bfloat16)}
        with pytest.raises(ValueError,
                           match=r"\['w'\].*\|V2 != expected bfloat16"):
            jstore.restore(path, jref)
        with pytest.raises(ValueError, match="No cast function"):
            jstore.restore(path, jref, cast=True)
